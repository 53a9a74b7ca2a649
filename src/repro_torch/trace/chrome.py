"""Chrome trace-event JSON export.

Emits the subset of the Trace Event Format that Perfetto and
``chrome://tracing`` render: one process ("DES"), one thread track per
rank, complete events (``ph="X"``) for spans, instant events (``"i"``)
for markers, and async begin/end pairs (``"b"``/``"e"``) for in-flight
p2p messages so a message posted under lookahead shows as a slice
spanning its whole network lifetime.  Timestamps are microseconds of
simulated time.

Open a dump at https://ui.perfetto.dev (drag the file in) or at
chrome://tracing.
"""
from __future__ import annotations

import json
from typing import Optional

# Keys every renderable event must carry (also what the schema test and
# external validators check).
REQUIRED_KEYS = ("ph", "ts", "pid", "tid", "name")

_PID = 0          # single simulated process; tracks are ranks


def _us(t: float) -> float:
    return t * 1e6


def to_chrome_json(trace, path: Optional[str] = None) -> dict:
    """Serialize a TraceRecorder to a Chrome trace-event dict; write it
    to ``path`` (if given) and return it."""
    events = [{
        "ph": "M", "ts": 0, "pid": _PID, "tid": 0,
        "name": "process_name", "args": {"name": "DES"},
    }]
    ranks = ({s.rank for s in trace.spans}
             | {m.src for m in trace.msgs}
             | {m.dst for m in trace.msgs})
    ranks |= {r for r, _, _, _ in trace.instants}
    for r in sorted(ranks):
        # rank -1 is the fault timeline (repro_torch.faults.inject.FAULT_TRACK)
        events.append({"ph": "M", "ts": 0, "pid": _PID, "tid": r,
                       "name": "thread_name",
                       "args": {"name": "faults" if r < 0
                                else f"rank {r}"}})
        events.append({"ph": "M", "ts": 0, "pid": _PID, "tid": r,
                       "name": "thread_sort_index",
                       "args": {"sort_index": r}})

    for s in trace.spans:
        if s.t1 <= s.t0 and s.name == "isend":
            continue                      # post anchors render as arrows
        ev = {"ph": "X", "ts": _us(s.t0), "dur": _us(s.dur),
              "pid": _PID, "tid": s.rank, "name": s.name, "cat": s.cat}
        if s.args:
            ev["args"] = s.args
        events.append(ev)

    for rank, name, t, args in trace.instants:
        ev = {"ph": "i", "ts": _us(t), "pid": _PID, "tid": rank,
              "name": name, "s": "t"}
        if args:
            ev["args"] = args
        events.append(ev)

    end = trace.makespan
    for m in trace.msgs:
        name = f"msg {m.src}->{m.dst}"
        common = {"pid": _PID, "cat": "msg", "id": m.mid, "name": name}
        events.append({"ph": "b", "ts": _us(m.t_post), "tid": m.src,
                       "args": {"bytes": m.nbytes, "tag": repr(m.tag)},
                       **common})
        t_done = m.t_done if m.t_done is not None else end
        events.append({"ph": "e", "ts": _us(t_done), "tid": m.dst,
                       **common})

    out = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"makespan_s": end}}
    if path is not None:
        with open(path, "w") as fh:
            json.dump(out, fh)
    return out


def validate_chrome_events(doc: dict) -> None:
    """Schema check: raises ValueError unless every event carries the
    required trace-event keys with sane types."""
    if "traceEvents" not in doc:
        raise ValueError("missing traceEvents")
    for ev in doc["traceEvents"]:
        for k in REQUIRED_KEYS:
            if k not in ev:
                raise ValueError(f"event {ev!r} missing {k!r}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {ev!r} has non-numeric ts")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"complete event {ev!r} missing dur")
