"""FaultSpec — degraded-platform scenarios as declarative, seeded data.

The paper's methodology predicts the *happy path*; Cornebize & Legrand
("Variability Matters", PAPERS.md) show that real TOP500-scale runs are
shaped by platform misbehaviour — slow nodes, flapping links, fail-stop
ranks.  This module makes that misbehaviour a first-class scenario axis:
a ``FaultSpec`` is a frozen, hashable, JSON-round-trip bundle of
``Fault`` records plus a seed, exactly like ``WorkloadSpec``/``Platform``
specs, so a degraded scenario can be shipped to the serving layer,
diffed, swept, and replayed bit-identically.

Fault kinds (the ``kind`` field):

  * ``straggler``      — rank ``rank`` computes ``factor``x slower over
    ``[start, start+duration)`` (duration 0 = rest of the run).
  * ``fail_stop``      — rank ``rank`` (or every rank on node ``node``)
    stops dead at ``start``; peers block at their next rendezvous with
    it, exactly like a real fail-stop process.
  * ``link_degrade``   — selected links run at ``factor``x capacity over
    ``[start, start+duration)``.  Selection: ``node`` (all links
    adjacent to that node) or ``link_frac`` (a seeded fraction of all
    links).
  * ``link_flap``      — selected links oscillate: ``factor``x capacity
    for ``duty*period`` then restored, repeated ``cycles`` times from
    ``start`` (a finite schedule, so the event heap always drains).
  * ``latency_jitter`` — every MPI send pays overhead scaled by a
    deterministic per-message draw from ``1 ± sigma`` while active.

Injection happens in ``repro_torch.faults.inject.FaultRuntime`` (DES) and
``repro_torch.faults.fastsim`` (batched closed-form mapping); this module
is pure data.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

FAULT_KINDS = ("straggler", "fail_stop", "link_degrade", "link_flap",
               "latency_jitter")

# which kinds the batched fastsim/stepsim mapping can express (the
# DES covers all of FAULT_KINDS) — see DESIGN.md §16 coverage matrix
FASTSIM_KINDS = ("straggler", "link_degrade", "link_flap",
                 "latency_jitter")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One fault event.  A single flat record keeps JSON round-trip and
    property-based generation trivial; ``__post_init__`` enforces the
    per-kind field contracts."""
    kind: str
    start: float = 0.0           # sim seconds
    duration: float = 0.0        # 0 = until the end of the run
    rank: int = -1               # straggler / fail_stop target
    node: int = -1               # link faults: links adjacent to node
    link_frac: float = 0.0       # link faults: seeded fraction of links
    factor: float = 1.0          # compute slowdown / capacity multiplier
    period: float = 0.0          # link_flap cycle length (s)
    duty: float = 0.5            # link_flap: degraded fraction of period
    cycles: int = 0              # link_flap repetitions
    sigma: float = 0.0           # latency_jitter spread

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in "
                             f"{FAULT_KINDS}")
        if self.start < 0 or self.duration < 0:
            raise ValueError(f"{self.kind}: start/duration must be >= 0")
        if self.kind == "straggler":
            if self.rank < 0:
                raise ValueError("straggler needs a rank >= 0")
            if self.factor <= 0:
                raise ValueError("straggler factor must be > 0 (compute-"
                                 "time multiplier; 2.0 = chip at 0.5x)")
        elif self.kind == "fail_stop":
            if self.rank < 0 and self.node < 0:
                raise ValueError("fail_stop needs a rank or a node")
        elif self.kind in ("link_degrade", "link_flap"):
            if self.node < 0 and not 0.0 < self.link_frac <= 1.0:
                raise ValueError(f"{self.kind} needs a node or a "
                                 "link_frac in (0, 1]")
            if not 0.0 < self.factor <= 1.0:
                raise ValueError(f"{self.kind} factor must be in (0, 1] "
                                 "(capacity multiplier)")
            if self.kind == "link_flap":
                if self.period <= 0 or self.cycles < 1:
                    raise ValueError("link_flap needs period > 0 and "
                                     "cycles >= 1 (finite schedule)")
                if not 0.0 < self.duty < 1.0:
                    raise ValueError("link_flap duty must be in (0, 1)")
        elif self.kind == "latency_jitter":
            if not 0.0 < self.sigma < 1.0:
                raise ValueError("latency_jitter needs sigma in (0, 1)")

    @property
    def end(self) -> float:
        """Deactivation time; ``inf`` for open-ended faults."""
        if self.kind == "fail_stop":
            return math.inf
        if self.kind == "link_flap":
            return self.start + self.cycles * self.period
        return self.start + self.duration if self.duration > 0 else math.inf

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Fault":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A degraded-platform scenario: a tuple of faults plus the seed
    that makes every seeded choice (link sampling, jitter draws)
    replay bit-identically."""
    faults: Tuple[Fault, ...] = ()
    seed: int = 0
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    # ------------------------------------------------------ constructors
    @staticmethod
    def straggler(rank: int, slowdown: float = 2.0, *, start: float = 0.0,
                  duration: float = 0.0, seed: int = 0) -> "FaultSpec":
        """One chip computing ``slowdown``x slower (2.0 = 0.5x speed)."""
        return FaultSpec(faults=(Fault("straggler", rank=rank,
                                       factor=slowdown, start=start,
                                       duration=duration),), seed=seed)

    @staticmethod
    def fail_stop(rank: int = -1, *, node: int = -1, at: float = 0.0,
                  seed: int = 0) -> "FaultSpec":
        return FaultSpec(faults=(Fault("fail_stop", rank=rank, node=node,
                                       start=at),), seed=seed)

    @staticmethod
    def degraded_links(frac: float, factor: float = 0.5, *,
                       start: float = 0.0, duration: float = 0.0,
                       seed: int = 0) -> "FaultSpec":
        """A seeded ``frac`` of all links at ``factor``x bandwidth."""
        return FaultSpec(faults=(Fault("link_degrade", link_frac=frac,
                                       factor=factor, start=start,
                                       duration=duration),), seed=seed)

    # ------------------------------------------------------- combinators
    def __add__(self, other: "FaultSpec") -> "FaultSpec":
        """Union of two scenarios (left spec's seed/name win)."""
        return FaultSpec(faults=self.faults + tuple(other.faults),
                         seed=self.seed, name=self.name or other.name)

    def with_fault(self, fault: Fault) -> "FaultSpec":
        return dataclasses.replace(self, faults=self.faults + (fault,))

    # ---------------------------------------------------------- queries
    @property
    def is_empty(self) -> bool:
        return not self.faults

    def by_kind(self, kind: str) -> List[Fault]:
        return [f for f in self.faults if f.kind == kind]

    def fastsim_supported(self) -> bool:
        """True when every fault has a batched closed-form mapping."""
        return all(f.kind in FASTSIM_KINDS for f in self.faults)

    # -------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, Any]:
        return {"seed": self.seed, "name": self.name,
                "faults": [f.to_dict() for f in self.faults]}

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultSpec":
        return cls(seed=d.get("seed", 0), name=d.get("name", ""),
                   faults=tuple(Fault.from_dict(f)
                                for f in d.get("faults", [])))

    @classmethod
    def from_json(cls, s: str) -> "FaultSpec":
        return cls.from_dict(json.loads(s))


NO_FAULTS = FaultSpec()


def as_fault_spec(faults) -> Optional[FaultSpec]:
    """Normalize a ``faults=`` argument: None/empty -> None, FaultSpec
    passes through, a dict/JSON string parses.  Returning None for the
    empty spec keeps the unfaulted paths bit-identical to pre-fault
    builds (no runtime is even constructed)."""
    if faults is None:
        return None
    if isinstance(faults, FaultSpec):
        return None if faults.is_empty else faults
    if isinstance(faults, str):
        return as_fault_spec(FaultSpec.from_json(faults))
    if isinstance(faults, dict):
        return as_fault_spec(FaultSpec.from_dict(faults))
    raise TypeError(f"faults must be a FaultSpec, dict, JSON string, or "
                    f"None, got {type(faults).__name__}")
