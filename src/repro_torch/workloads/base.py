"""The workload layer: one App abstraction drives every application the
framework can predict, over any ``Platform``.

A ``Workload`` binds an application's scenario knobs (its
``WorkloadSpec``) to the simulation backends every app offers:

  * ``des_app(platform)``      — the discrete-event application (per-rank
    virtual threads issuing flows on the host; contention is emergent);
  * ``fastsim_model(platform)``— a ``FastModel``: a parameter set plus
    batched sweep entry points, so scenario grids run as one batch.

``WorkloadSpec`` is frozen, hashable data (JSON round-trip) so a
scenario can be shipped to the serving layer, diffed, and versioned
exactly like a ``Platform``.  The registry maps workload kind names
("hpl", "transformer", ...) to classes; ``get_workload("hpl", N=4096)``
is the one call site every benchmark, example, and service goes
through.
"""
from __future__ import annotations

import abc
import dataclasses
import difflib
import json
from typing import Any, ClassVar, Dict, List, Optional, Sequence, Tuple, Type

from repro_torch._device import DeviceLike

_JSON_SCALARS = (str, int, float, bool, type(None))


def _freeze(v):
    """Normalize a JSON-safe value for the frozen params table (lists
    become tuples so specs stay hashable)."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, _JSON_SCALARS):
        return v
    raise TypeError(f"WorkloadSpec params must be JSON-safe scalars or "
                    f"lists, got {type(v).__name__}: {v!r}")


def _thaw(v):
    if isinstance(v, tuple):
        return [_thaw(x) for x in v]
    return v


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One application scenario as data: the workload ``kind`` (registry
    key) plus its knob table.  The params table is normalized (sorted,
    tuples for sequences) so equal scenarios compare and hash equal and
    round-trip through JSON exactly."""
    kind: str
    params: Tuple[Tuple[str, Any], ...] = ()
    name: str = ""

    def __post_init__(self):
        object.__setattr__(
            self, "params",
            tuple(sorted((str(k), _freeze(v)) for k, v in self.params)))

    @classmethod
    def make(cls, kind: str, name: str = "", **params) -> "WorkloadSpec":
        return cls(kind=kind, name=name, params=tuple(params.items()))

    @property
    def params_dict(self) -> Dict[str, Any]:
        return dict(self.params)

    def get(self, key: str, default=None):
        return self.params_dict.get(key, default)

    def replace(self, **over) -> "WorkloadSpec":
        merged = dict(self.params)
        merged.update(over)
        return WorkloadSpec(kind=self.kind, params=tuple(merged.items()),
                            name=self.name)

    # -------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "name": self.name,
                "params": [[k, _thaw(v)] for k, v in self.params]}

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkloadSpec":
        return cls(kind=d["kind"], name=d.get("name", ""),
                   params=tuple((k, v) for k, v in d.get("params", [])))

    @classmethod
    def from_json(cls, s: str) -> "WorkloadSpec":
        return cls.from_dict(json.loads(s))


class FastModel(abc.ABC):
    """A workload's vectorized-simulator surface: ``params`` is a frozen
    dataclass, so hardware what-ifs are ``dataclasses.replace`` away;
    ``sweep`` runs a params grid as one batch.  ``sweep_models`` batches
    *across* scenarios of the same workload family — the serving layer's
    wave dispatch."""

    params: Any

    def sweep(self, params_list: Sequence[Any], *,
              device: DeviceLike = "cuda") -> List[dict]:
        """One batch over params variants of this scenario."""
        return type(self).sweep_models(
            [dataclasses.replace(self, params=p) for p in params_list],
            device=device)

    def predict(self, params=None, *, device: DeviceLike = "cuda") -> dict:
        return self.sweep([self.params if params is None else params],
                          device=device)[0]

    @classmethod
    @abc.abstractmethod
    def sweep_models(cls, models: Sequence["FastModel"], *,
                     device: DeviceLike = "cuda") -> List[dict]:
        """Batch heterogeneous scenarios of this family in one sweep."""


class Workload(abc.ABC):
    """One application the framework can predict.  Subclasses set
    ``kind``, register with ``@register_workload``, and implement the
    backend hooks; construction takes a spec and/or param overrides:
    ``HPLWorkload(N=4096, nb=128)``."""

    kind: ClassVar[str] = ""

    def __init__(self, spec: Optional[WorkloadSpec] = None, **params):
        base = spec if spec is not None else self.default_spec()
        if base.kind != self.kind:
            raise ValueError(f"{type(self).__name__} got a spec of kind "
                             f"{base.kind!r} (expected {self.kind!r})")
        if params:
            base = base.replace(**params)
        self.spec = base

    @classmethod
    def default_spec(cls) -> WorkloadSpec:
        return WorkloadSpec(kind=cls.kind)

    # ------------------------------------------------- backend hooks
    @abc.abstractmethod
    def validate(self, platform) -> None:
        """Raise ValueError when the scenario cannot run on ``platform``
        (capacity, fabric kind, missing defaults)."""

    @abc.abstractmethod
    def des_app(self, platform, *, trace: bool = False, faults=None,
                regions=None, device: DeviceLike = "cuda"):
        """The discrete-event application, built from the platform spec;
        the returned object has ``.run()`` and (traced) ``.trace``.
        ``faults`` is an optional ``repro_torch.faults.FaultSpec`` (or
        dict / JSON form) injected into the run.  ``regions`` (an int
        region length or a ``repro_torch.scale.RegionSpec``) switches to
        representative-region simulation: one region of the iteration
        space runs on the exact DES (on the host) and the rest is
        replicated analytically; results are stamped ``region_approx``.
        ``device`` is where a region tail with a closed form is priced
        (HPL's, by fastsim); a workload whose DES runs only on the host
        accepts it and ignores it, so callers pass it uniformly."""

    @abc.abstractmethod
    def fastsim_model(self, platform, *, faults=None) -> FastModel:
        """The vectorized-simulator surface for this scenario.  A
        ``faults`` scenario is folded into the params
        (``repro_torch.faults.fastsim.apply_faults``) — straggler and
        bandwidth kinds only; fail-stop raises (DES-only)."""

    def des_ranks(self, platform) -> int:
        """How many DES ranks ``des_app`` would spawn (serving guard)."""
        raise NotImplementedError

    # ------------------------------------------------- conveniences
    def predict(self, platform, *, faults=None,
                device: DeviceLike = "cuda") -> dict:
        """Fast prediction of this scenario on ``platform``, optionally
        under a degraded-platform ``faults`` scenario."""
        self.validate(platform)
        return self.fastsim_model(platform, faults=faults).predict(
            device=device)

    @abc.abstractmethod
    def predict_des(self, platform, *, trace: bool = False,
                    faults=None, regions=None) -> dict:
        """Full-DES prediction; with ``trace=True`` the result carries a
        ``breakdown``.  ``faults`` injects a degraded-platform scenario
        (fail-stop runs report ``failed=True``); ``regions`` requests
        representative-region simulation (see ``des_app``), stamped
        ``region_approx=True``."""

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.spec.params_dict})"


# ------------------------------------------------------------- registry
_WORKLOADS: Dict[str, Type[Workload]] = {}


def register_workload(cls: Type[Workload]) -> Type[Workload]:
    if not cls.kind:
        raise ValueError(f"{cls.__name__} must set a non-empty kind")
    if cls.kind in _WORKLOADS and _WORKLOADS[cls.kind] is not cls:
        raise ValueError(f"workload kind {cls.kind!r} already registered "
                         f"by {_WORKLOADS[cls.kind].__name__}")
    _WORKLOADS[cls.kind] = cls
    return cls


def get_workload(name: str, spec: Optional[WorkloadSpec] = None,
                 **params) -> Workload:
    """Instantiate a registered workload by kind name, optionally from a
    spec and/or with param overrides."""
    try:
        cls = _WORKLOADS[name]
    except KeyError:
        close = difflib.get_close_matches(name, _WORKLOADS, n=3, cutoff=0.5)
        hint = (f"did you mean: {', '.join(close)}?" if close
                else f"registered: {', '.join(sorted(_WORKLOADS))}")
        raise KeyError(f"unknown workload {name!r}; {hint}") from None
    return cls(spec=spec, **params)


def workload_from_spec(spec: WorkloadSpec) -> Workload:
    return get_workload(spec.kind, spec=spec)


def list_workloads() -> List[str]:
    return sorted(_WORKLOADS)
