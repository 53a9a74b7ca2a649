"""Content-addressed result cache for the prediction services.

The fleet traffic the campaign layer (and any what-if UI) generates is
mostly *duplicate cells*: the same (workload, platform, faults, regions)
tuple asked again and again across waves, editions, and users.  Every
spec in the stack is frozen, hashable, JSON-round-trip data, so a
scenario has a canonical serialized form — which means a prediction is
*content-addressable*: the cache key is a digest of the serialized
scenario tuple, never of object identity or registry names.

Key properties:

  * **Canonical** — ``request_key`` digests the resolved
    ``WorkloadSpec`` (params folded, so ``get_workload("hpl", N=4096)``
    and an equal explicit spec collide), the full ``Platform`` content
    (not its name — two registries disagreeing about "frontera" can
    never cross-serve), the normalized ``FaultSpec`` and region spec,
    and the breakdown flag.  Any field change anywhere in that tuple
    changes the key.
  * **Bounded** — LRU over ``max_entries``; hits refresh recency.
  * **Invalidation** — re-registering (or unregistering) a platform
    name drops every entry derived from that name via the registry
    hook below.  Content addressing already guarantees a *changed*
    platform can never serve stale payloads (its digest differs); the
    explicit invalidation is memory hygiene plus a hard guarantee for
    audit-style callers.
  * **Never caches failures** — the service only inserts successful,
    deadline-free payloads; error and degraded results are recomputed
    every time.

Payloads are stored and served as deep copies, so callers can mutate
their results freely without poisoning the cache.

This is the port of ``repro.serve.cache``: host Python, no device.  The
specs serialize as the reference's do, so equal requests get equal keys
in both packages.
"""
from __future__ import annotations

import functools
import hashlib
import threading
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["ResultCache", "as_result_cache", "request_key",
           "platform_digest", "spec_digest", "fault_digest",
           "copy_payload"]


def copy_payload(x):
    """Deep copy of a JSON-shaped result payload (dict/list/tuple of
    scalars).  Payloads are journaling-safe plain data by contract, so
    this beats ``copy.deepcopy`` by ~10x on the cache hit path; scalars
    are immutable and shared as-is, so hits stay bit-identical."""
    if isinstance(x, dict):
        return {k: copy_payload(v) for k, v in x.items()}
    if isinstance(x, list):
        return [copy_payload(v) for v in x]
    if isinstance(x, tuple):
        return tuple(copy_payload(v) for v in x)
    return x


# --------------------------------------------------------------- digests
@functools.lru_cache(maxsize=4096)
def platform_digest(platform) -> str:
    """Stable content digest of a ``Platform`` (memoized per spec — the
    registry holds specs alive, so repeat requests pay a dict hash, not
    a JSON serialization)."""
    return hashlib.sha256(
        platform.to_json(sort_keys=True).encode()).hexdigest()


@functools.lru_cache(maxsize=4096)
def spec_digest(spec) -> str:
    """Stable content digest of a ``WorkloadSpec``."""
    return hashlib.sha256(spec.to_json(sort_keys=True).encode()).hexdigest()


@functools.lru_cache(maxsize=4096)
def fault_digest(fault_spec) -> str:
    """Stable content digest of a normalized ``FaultSpec`` (or None)."""
    if fault_spec is None:
        return ""
    return hashlib.sha256(
        fault_spec.to_json(sort_keys=True).encode()).hexdigest()


def _regions_token(regions) -> str:
    """Canonical token for the ``regions=`` axis: None (exact fastsim
    answer) stays distinct from every region request; an int and the
    equivalent ``RegionSpec`` collide (same semantics)."""
    if regions is None:
        return ""
    from repro_torch.scale import as_region
    r = as_region(regions)
    return f"r{r.panels}w{r.warmup}"


def request_key(workload_spec, platform, *, faults=None, regions=None,
                breakdown: bool = False) -> str:
    """The content-addressed key of one prediction request.

    ``workload_spec`` is the *resolved* ``WorkloadSpec`` (request params
    already folded in), ``platform`` the resolved ``Platform``;
    ``faults`` may be a ``FaultSpec``, dict, or JSON string (normalized
    through ``as_fault_spec``, so equal scenarios in different notations
    collide).  Sensitivity is total: any field change in any component
    yields a different key.
    """
    from repro_torch.faults import as_fault_spec
    parts = (spec_digest(workload_spec), platform_digest(platform),
             fault_digest(as_fault_spec(faults)), _regions_token(regions),
             "breakdown" if breakdown else "")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


# ----------------------------------------------------------------- cache
#: every live cache, for registry-driven invalidation fan-out
_LIVE_CACHES: "weakref.WeakSet[ResultCache]" = weakref.WeakSet()
_HOOK_INSTALLED = False
_HOOK_LOCK = threading.Lock()


def _install_registry_hook() -> None:
    """Idempotently subscribe to platform re-registration events so
    every live cache drops entries derived from the re-registered
    name (serve imports platforms, never the reverse)."""
    global _HOOK_INSTALLED
    with _HOOK_LOCK:
        if _HOOK_INSTALLED:
            return
        from repro_torch.platforms.registry import add_invalidation_hook

        def _on_reregister(name: str) -> None:
            for cache in list(_LIVE_CACHES):
                cache.invalidate_platform(name)

        add_invalidation_hook(_on_reregister)
        _HOOK_INSTALLED = True


class ResultCache:
    """LRU result cache keyed by :func:`request_key` digests.

    Entries carry the platform *name* they were resolved from so
    registry re-registration can invalidate by name; correctness never
    depends on it (the key is content-addressed), it is hygiene.
    """

    def __init__(self, max_entries: int = 4096):
        if max_entries < 1:
            raise ValueError(f"ResultCache: max_entries={max_entries} "
                             "must be >= 1")
        self.max_entries = int(max_entries)
        #: key -> (payload, platform_name)
        self._data: "OrderedDict[str, Tuple[dict, Optional[str]]]" = \
            OrderedDict()
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self.invalidations = 0
        _LIVE_CACHES.add(self)
        _install_registry_hook()

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str) -> Optional[dict]:
        """Deep copy of the payload under ``key`` (refreshes recency),
        or None.  Counts a hit or a miss."""
        entry = self._data.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._data.move_to_end(key)
        self.hits += 1
        return copy_payload(entry[0])

    def put(self, key: str, payload: dict, *,
            platform: Optional[str] = None) -> None:
        """Insert (a deep copy of) ``payload``; evicts least-recently-
        used entries past ``max_entries``."""
        self._data[key] = (copy_payload(payload), platform)
        self._data.move_to_end(key)
        self.insertions += 1
        while len(self._data) > self.max_entries:
            self._data.popitem(last=False)
            self.evictions += 1

    def invalidate_platform(self, name: str) -> int:
        """Drop every entry resolved from platform ``name``; returns
        how many were dropped."""
        stale = [k for k, (_, pname) in self._data.items() if pname == name]
        for k in stale:
            del self._data[k]
        self.invalidations += len(stale)
        return len(stale)

    def clear(self) -> None:
        self._data.clear()

    def stats(self) -> Dict[str, Any]:
        return {"entries": len(self._data), "capacity": self.max_entries,
                "hits": self.hits, "misses": self.misses,
                "insertions": self.insertions, "evictions": self.evictions,
                "invalidations": self.invalidations}

    def keys(self) -> List[str]:
        """Keys in LRU order (oldest first) — eviction-order tests."""
        return list(self._data)

    def __repr__(self) -> str:
        return (f"ResultCache({len(self._data)}/{self.max_entries} "
                f"entries, {self.hits} hits, {self.misses} misses)")


def as_result_cache(cache) -> Optional[ResultCache]:
    """Normalize the service's ``cache=`` argument: None/False -> off,
    True -> a fresh default-sized cache, an int -> that capacity, a
    ``ResultCache`` -> itself (share one across services to share
    results)."""
    if cache is None or cache is False:
        return None
    if cache is True:
        return ResultCache()
    if isinstance(cache, int):
        return ResultCache(max_entries=cache)
    if isinstance(cache, ResultCache):
        return cache
    raise TypeError(f"cache must be None/bool/int/ResultCache, got "
                    f"{type(cache).__name__}")
