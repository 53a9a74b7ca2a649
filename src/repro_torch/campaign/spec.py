"""CampaignSpec — declarative fleet studies as frozen, shippable data.

The paper's headline number is fleet-scale (HPL across a TOP500 list at
a few percent error), yet every fleet study so far has been a one-shot
script.  hpcbench drives everything from YAML campaigns (a benchmark x
platform matrix plus merge/report tools); this module is the analogous
surface for the prediction stack: one ``CampaignSpec`` names WHAT to
study — workloads, platforms, sweep axes, fault scenarios, seeds — and
``repro_torch.campaign.matrix.expand`` turns it into a deterministic run
matrix the executor routes through the batched engines.

Like every other spec in the repo (``Platform``, ``WorkloadSpec``,
``FaultSpec``), a campaign is frozen, hashable data with an exact JSON
round trip, so studies can be versioned, diffed, and replayed:

    spec = CampaignSpec.make(
        "edition-drift",
        workloads=["hpl"],
        platforms=[{"top500": "sample:2020_06"},
                   {"top500": "sample:2020_11"}],
        seeds=[0])
    CampaignSpec.from_json(spec.to_json()) == spec     # always

Platform selectors come in two kinds, mirroring how the repo names
machines:

  * ``{"registry": "frontera"}`` — one registered platform; expands
    against the workload/axis/fault/seed grid ("grid" runs, served
    through ``PredictionService``).
  * ``{"top500": <csv path or "sample:<edition>">}`` — a whole list
    edition; every parseable row becomes one machine ("fleet" runs,
    served through ``top500.predict_fleet`` — one compile for the whole
    edition, per-fabric calibration included).  ``edition`` labels the
    group (defaults to the sample edition or the file stem); ``limit``
    caps how many top rows are taken.

Axes are named workload knobs (``{"N": [4096, 8192]}``) crossed
cartesianly; an axis key must be a knob of at least one workload in the
campaign and is applied only to the workloads that know it.  Unknown
workload kinds, platform names, and axis keys all fail fast with
difflib close-match hints, matching the ``get_platform`` error UX.
"""
from __future__ import annotations

import dataclasses
import difflib
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.faults.spec import FaultSpec
from repro_torch.workloads.base import WorkloadSpec

CAMPAIGN_VERSION = 1

_JSON_SCALARS = (str, int, float, bool, type(None))

#: workload knobs that are legal axis keys but absent from the kind's
#: default spec (geometry/config keys resolved per platform)
EXTRA_AXIS_KEYS: Dict[str, Tuple[str, ...]] = {
    "hpl": ("N", "nb", "P", "Q", "bcast", "lookahead"),
    "transformer": ("mesh", "pods"),
}


def _freeze(v):
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, _JSON_SCALARS):
        return v
    raise TypeError(f"campaign axis values must be JSON-safe scalars or "
                    f"lists, got {type(v).__name__}: {v!r}")


def _thaw(v):
    if isinstance(v, tuple):
        return [_thaw(x) for x in v]
    return v


def _hint(name: str, candidates: Sequence[str]) -> str:
    """The close-match suffix every campaign spec error carries (same
    UX as ``platforms.get_platform``)."""
    close = difflib.get_close_matches(name, list(candidates), n=3,
                                      cutoff=0.5)
    if close:
        return f"did you mean: {', '.join(close)}?"
    return f"known: {', '.join(sorted(candidates))}"


@dataclasses.dataclass(frozen=True)
class PlatformSelector:
    """One platform source: exactly one of ``registry`` (a registered
    platform name) or ``top500`` (a list export path, raw CSV text, or
    ``"sample:<edition>"`` for a vendored sample edition)."""
    registry: str = ""
    top500: str = ""
    edition: str = ""            # fleet group label (top500 only)
    limit: int = 0               # 0 = every parseable row

    def __post_init__(self):
        if bool(self.registry) == bool(self.top500):
            raise ValueError(
                "PlatformSelector needs exactly one of registry=<name> "
                f"or top500=<source>, got registry={self.registry!r} "
                f"top500={self.top500!r}")
        if self.limit < 0:
            raise ValueError(f"selector limit must be >= 0, "
                             f"got {self.limit}")
        if self.registry and self.edition:
            raise ValueError("edition labels apply to top500 selectors "
                             f"only (registry={self.registry!r})")

    @property
    def kind(self) -> str:
        return "registry" if self.registry else "top500"

    def edition_label(self) -> str:
        """The fleet group label: explicit ``edition``, else derived
        from the source (sample edition name or file stem)."""
        if self.edition:
            return self.edition
        src = self.top500
        if src.startswith("sample:"):
            return src[len("sample:"):]
        stem = src.replace("\\", "/").rsplit("/", 1)[-1]
        return stem.rsplit(".", 1)[0] if "." in stem else stem

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.registry:
            d["registry"] = self.registry
        else:
            d["top500"] = self.top500
        if self.edition:
            d["edition"] = self.edition
        if self.limit:
            d["limit"] = self.limit
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PlatformSelector":
        return cls(registry=d.get("registry", ""),
                   top500=d.get("top500", ""),
                   edition=d.get("edition", ""),
                   limit=int(d.get("limit", 0)))


@dataclasses.dataclass(frozen=True)
class Budget:
    """Hard caps the expansion refuses to exceed — a campaign that
    would fan out past its budget raises at expand time instead of
    melting the serving layer."""
    max_runs: int = 4096

    def __post_init__(self):
        if self.max_runs < 1:
            raise ValueError(f"budget max_runs must be >= 1, "
                             f"got {self.max_runs}")

    def to_dict(self) -> Dict[str, Any]:
        return {"max_runs": self.max_runs}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Budget":
        return cls(max_runs=int(d.get("max_runs", 4096)))


def _as_workload_spec(w) -> WorkloadSpec:
    if isinstance(w, WorkloadSpec):
        return w
    if isinstance(w, str):
        # a bare kind name means the kind's default scenario — resolve
        # it now so the journaled spec records the actual knob values
        # (an unknown kind passes through; validate() hints on it)
        from repro_torch.workloads import get_workload
        try:
            return get_workload(w).spec
        except KeyError:
            return WorkloadSpec(kind=w)
    if isinstance(w, dict):
        return WorkloadSpec.from_dict(w)
    raise TypeError(f"campaign workload must be a kind name, dict, or "
                    f"WorkloadSpec, got {type(w).__name__}")


def _as_selector(p) -> PlatformSelector:
    if isinstance(p, PlatformSelector):
        return p
    if isinstance(p, str):
        return PlatformSelector(registry=p)
    if isinstance(p, dict):
        return PlatformSelector.from_dict(p)
    raise TypeError(f"campaign platform must be a registry name, dict, "
                    f"or PlatformSelector, got {type(p).__name__}")


def _as_fault(f) -> Optional[FaultSpec]:
    if f is None or isinstance(f, FaultSpec):
        return f
    if isinstance(f, dict):
        return FaultSpec.from_dict(f)
    if isinstance(f, str):
        return FaultSpec.from_json(f)
    raise TypeError(f"campaign fault scenario must be a FaultSpec, "
                    f"dict, JSON string, or None, got {type(f).__name__}")


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """One declarative study: ``workloads x platforms x axes x faults x
    seeds``.  Frozen and hashable; ``to_json``/``from_json`` round-trip
    exactly (normalization happens in ``__post_init__``, so equal
    studies compare equal however they were spelled)."""
    name: str
    workloads: Tuple[WorkloadSpec, ...] = ()
    platforms: Tuple[PlatformSelector, ...] = ()
    axes: Tuple[Tuple[str, Tuple[Any, ...]], ...] = ()
    faults: Tuple[Optional[FaultSpec], ...] = (None,)
    seeds: Tuple[int, ...] = (0,)
    budget: Budget = Budget()

    def __post_init__(self):
        if not self.name:
            raise ValueError("campaign needs a non-empty name")
        if not self.platforms:
            raise ValueError(f"campaign {self.name!r} selects no "
                             "platforms")
        if any(s.kind == "registry" for s in self.platforms) \
                and not self.workloads:
            raise ValueError(
                f"campaign {self.name!r} has registry platform selectors "
                "but no workloads to run on them")
        axes = []
        seen = set()
        for k, vals in self.axes:
            k = str(k)
            if k in seen:
                raise ValueError(f"campaign {self.name!r}: duplicate "
                                 f"axis {k!r}")
            seen.add(k)
            vals = tuple(_freeze(v) for v in vals)
            if not vals:
                raise ValueError(f"campaign {self.name!r}: axis {k!r} "
                                 "has no values")
            axes.append((k, vals))
        object.__setattr__(self, "axes", tuple(sorted(axes)))
        object.__setattr__(self, "workloads", tuple(self.workloads))
        object.__setattr__(self, "platforms", tuple(self.platforms))
        object.__setattr__(self, "faults", tuple(self.faults) or (None,))
        object.__setattr__(self, "seeds",
                           tuple(int(s) for s in self.seeds) or (0,))

    # ---------------------------------------------------- construction
    @classmethod
    def make(cls, name: str, *, workloads: Sequence = (),
             platforms: Sequence = (), axes: Optional[Dict] = None,
             faults: Sequence = (None,), seeds: Sequence[int] = (0,),
             max_runs: int = 4096) -> "CampaignSpec":
        """The permissive constructor: workloads as kind names / dicts /
        specs, platforms as registry names / dicts / selectors, axes as
        a plain ``{key: [values]}`` dict."""
        return cls(
            name=name,
            workloads=tuple(_as_workload_spec(w) for w in workloads),
            platforms=tuple(_as_selector(p) for p in platforms),
            axes=tuple((k, tuple(v)) for k, v in (axes or {}).items()),
            faults=tuple(_as_fault(f) for f in faults),
            seeds=tuple(seeds),
            budget=Budget(max_runs=max_runs))

    # ------------------------------------------------------ validation
    def axis_candidates(self) -> Dict[str, Tuple[str, ...]]:
        """Per workload kind, the knob names an axis may legally set:
        the kind's default-spec params, this spec's own params, and the
        per-kind extras (platform-resolved config keys)."""
        from repro_torch.workloads import get_workload, list_workloads
        out: Dict[str, Tuple[str, ...]] = {}
        known = set(list_workloads())
        for w in self.workloads:
            if w.kind not in known:
                continue                 # reported by validate()
            keys = set(dict(w.params))
            keys.update(
                dict(type(get_workload(w.kind)).default_spec().params))
            keys.update(EXTRA_AXIS_KEYS.get(w.kind, ()))
            out[w.kind] = tuple(sorted(keys))
        return out

    def validate(self) -> None:
        """Fail fast — unknown workload kinds, registry platform names,
        and axis keys all raise ``ValueError`` with a difflib
        close-match hint (the ``get_platform`` error UX)."""
        from repro_torch.platforms import list_platforms
        from repro_torch.workloads import list_workloads
        kinds = list_workloads()
        for w in self.workloads:
            if w.kind not in kinds:
                raise ValueError(
                    f"campaign {self.name!r}: unknown workload kind "
                    f"{w.kind!r}; {_hint(w.kind, kinds)}")
        names = list_platforms()
        for sel in self.platforms:
            if sel.kind == "registry" and sel.registry not in names:
                raise ValueError(
                    f"campaign {self.name!r}: unknown platform "
                    f"{sel.registry!r}; {_hint(sel.registry, names)}")
        candidates = self.axis_candidates()
        legal = sorted({k for keys in candidates.values() for k in keys})
        for key, _ in self.axes:
            if not any(key in keys for keys in candidates.values()):
                raise ValueError(
                    f"campaign {self.name!r}: axis key {key!r} is not a "
                    f"knob of any campaign workload "
                    f"({', '.join(sorted(candidates)) or 'none'}); "
                    f"{_hint(key, legal)}")

    # -------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, Any]:
        return {
            "campaign": CAMPAIGN_VERSION,
            "name": self.name,
            "workloads": [w.to_dict() for w in self.workloads],
            "platforms": [s.to_dict() for s in self.platforms],
            "axes": [[k, [_thaw(v) for v in vals]]
                     for k, vals in self.axes],
            "faults": [None if f is None else f.to_dict()
                       for f in self.faults],
            "seeds": list(self.seeds),
            "budget": self.budget.to_dict(),
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CampaignSpec":
        ver = d.get("campaign", CAMPAIGN_VERSION)
        if ver != CAMPAIGN_VERSION:
            raise ValueError(f"unsupported campaign spec version {ver} "
                             f"(this build speaks {CAMPAIGN_VERSION})")
        return cls(
            name=d["name"],
            workloads=tuple(WorkloadSpec.from_dict(w)
                            for w in d.get("workloads", [])),
            platforms=tuple(PlatformSelector.from_dict(s)
                            for s in d.get("platforms", [])),
            axes=tuple((k, tuple(vals))
                       for k, vals in d.get("axes", [])),
            faults=tuple(None if f is None else FaultSpec.from_dict(f)
                         for f in d.get("faults", [None])),
            seeds=tuple(d.get("seeds", [0])),
            budget=Budget.from_dict(d.get("budget", {})))

    @classmethod
    def from_json(cls, s: str) -> "CampaignSpec":
        return cls.from_dict(json.loads(s))

    def load(path) -> "CampaignSpec":
        with open(path) as fh:
            return CampaignSpec.from_json(fh.read())
    load = staticmethod(load)
