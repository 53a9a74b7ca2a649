"""Trace analysis: breakdowns and critical-path extraction.

Works on the leaf spans of a TraceRecorder (``cat`` in compute/comm,
``nested`` False — time inside a collective is carried by the collective
span itself, and ``phase`` spans are presentation overlays).  Because
every rank is a sequential virtual thread, leaf spans on one rank never
overlap, which gives the accounting identity the tests enforce:

    compute + comm + idle == makespan        (per rank, idle >= 0)

Critical-path extraction walks the recorded happens-before graph
backwards from the last-finishing span.  Predecessor candidates of a
span are (a) the previous leaf span on the same rank, (b) the post
anchors of the messages it received (send->recv edges), and (c) for a
collective member, the last-arriving member of the same collective
instance (the rank everyone ended up waiting for).  The path is built as
disjoint time segments clipped at the running frontier, so its length is
<= makespan by construction and equals it exactly for a serial chain.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

_EPS = 1e-12


def _leaf_spans(trace) -> List:
    return [s for s in trace.spans
            if not s.nested and s.cat in ("compute", "comm")]


def rank_breakdown(trace, makespan: Optional[float] = None
                   ) -> Dict[int, Dict[str, float]]:
    """Per-rank {compute, comm, idle, total}; idle is the remainder up to
    the global makespan (ranks that finish early idle at the end)."""
    T = trace.makespan if makespan is None else makespan
    out: Dict[int, Dict[str, float]] = {}
    for s in _leaf_spans(trace):
        acc = out.setdefault(s.rank, {"compute": 0.0, "comm": 0.0})
        acc[s.cat] += s.dur
    for acc in out.values():
        acc["idle"] = T - acc["compute"] - acc["comm"]
        acc["total"] = T
    return out


def phase_breakdown(trace) -> Dict[str, float]:
    """Total time in each application phase, summed over ranks."""
    out: Dict[str, float] = {}
    for s in trace.spans:
        if s.cat == "phase":
            out[s.name] = out.get(s.name, 0.0) + s.dur
    return out


def collective_breakdown(trace) -> Dict[str, Dict[str, float]]:
    """Per-collective-kind attribution over non-nested collective spans:
    total rank-seconds, call count, mean seconds per member call."""
    out: Dict[str, Dict[str, float]] = {}
    for s in trace.spans:
        if s.coll is None or s.nested:
            continue
        acc = out.setdefault(s.name, {"seconds": 0.0, "calls": 0})
        acc["seconds"] += s.dur
        acc["calls"] += 1
    for acc in out.values():
        acc["mean_s"] = acc["seconds"] / max(acc["calls"], 1)
    return out


@dataclasses.dataclass
class CriticalPath:
    length_s: float                      # sum of disjoint path segments
    makespan_s: float
    spans: List                          # path spans, start -> finish
    by_cat: Dict[str, float]             # path time per category
    by_name: Dict[str, float]            # path time per span name

    @property
    def coverage(self) -> float:
        """Fraction of the makespan explained by the path."""
        return self.length_s / self.makespan_s if self.makespan_s else 0.0


def critical_path(trace) -> CriticalPath:
    spans = _leaf_spans(trace)
    T = trace.makespan
    if not spans:
        return CriticalPath(0.0, T, [], {}, {})
    by_sid = {s.sid: s for s in trace.spans}

    # per-rank timelines ordered by (t0, sid) for prev-span lookup
    by_rank: Dict[int, List] = {}
    for s in spans:
        by_rank.setdefault(s.rank, []).append(s)
    starts: Dict[int, List[Tuple[float, int]]] = {}
    for r, ss in by_rank.items():
        ss.sort(key=lambda s: (s.t0, s.sid))
        starts[r] = [(s.t0, s.sid) for s in ss]

    def rank_prev(s):
        i = bisect.bisect_left(starts[s.rank], (s.t0, s.sid))
        return by_rank[s.rank][i - 1] if i > 0 else None

    def anchor_leaf(sid):
        """Map a (possibly nested) span to the leaf span covering it on
        its rank — e.g. an isend anchor inside a collective maps to the
        enclosing collective span."""
        a = by_sid[sid]
        if not a.nested and a.cat in ("compute", "comm"):
            return a
        lst = starts.get(a.rank)
        if not lst:
            return None
        i = bisect.bisect_right(lst, (a.t0, a.sid))
        return by_rank[a.rank][i - 1] if i > 0 else None

    # last-arriving member per collective instance
    last_arriver: Dict = {}
    for key, sids in trace.coll_members.items():
        members = [by_sid[i] for i in sids]
        last_arriver[key] = max(members, key=lambda s: (s.t0, s.sid))

    cur = max(spans, key=lambda s: (s.t1, s.sid))
    frontier = T
    path: List = []
    length = 0.0
    by_cat: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    seen = set()
    while cur is not None and cur.sid not in seen:
        seen.add(cur.sid)
        cands = []
        prev = rank_prev(cur)
        if prev is not None:
            cands.append(prev)
        for dep in cur.deps:
            a = anchor_leaf(dep)
            if a is not None and a.sid != cur.sid:
                cands.append(a)
        if cur.coll is not None:
            la = last_arriver.get(cur.coll)
            if la is not None and la.sid != cur.sid:
                cands.append(la)
        cands = [c for c in cands if c.sid not in seen]
        pred = max(cands, key=lambda s: (s.t1, s.sid)) if cands else None
        # the span's own contribution starts only after its predecessor
        # finished — a recv blocked from t0 waiting for a slow sender
        # contributes just the transfer tail, and the walk routes the
        # rest of the time through the sender's chain
        seg_start = cur.t0 if pred is None else max(cur.t0, pred.t1)
        seg = max(0.0, min(cur.t1, frontier) - seg_start)
        if seg > 0.0:
            path.append(cur)
            length += seg
            by_cat[cur.cat] = by_cat.get(cur.cat, 0.0) + seg
            by_name[cur.name] = by_name.get(cur.name, 0.0) + seg
        frontier = min(frontier, seg_start)
        cur = pred
    path.reverse()
    return CriticalPath(length, T, path, by_cat, by_name)


def summarize(trace) -> dict:
    """One JSON-friendly report: what the service/benchmarks return."""
    T = trace.makespan
    ranks = rank_breakdown(trace, T)
    n = max(len(ranks), 1)
    tot = {k: sum(r[k] for r in ranks.values()) / n
           for k in ("compute", "comm", "idle")}
    cp = critical_path(trace)
    return {
        "makespan_s": T,
        "n_ranks": len(ranks),
        "n_spans": len(trace.spans),
        "n_msgs": len(trace.msgs),
        "compute_frac": tot["compute"] / T if T else 0.0,
        "comm_frac": tot["comm"] / T if T else 0.0,
        "idle_frac": tot["idle"] / T if T else 0.0,
        "phases": phase_breakdown(trace),
        "collectives": collective_breakdown(trace),
        "critical_path_s": cp.length_s,
        "critical_path_coverage": cp.coverage,
        "critical_path_by_cat": cp.by_cat,
        "faults": [dict({"name": s.name, "t0": s.t0, "t1": s.t1},
                        **(s.args or {}))
                   for s in trace.spans if s.cat == "fault"],
    }
