"""TraceRecorder — per-rank event timelines for the DES.

The recorder hangs off ``Engine`` (``engine.trace``).  When tracing is
off the engine carries the module-level ``NULL_RECORDER`` singleton whose
methods are no-ops and whose ``enabled`` flag is False, so every
instrumentation site reduces to one attribute test and the hot event
loop pays nothing; crucially the recorder never schedules engine events,
so a traced run replays the exact same heap sequence as an untraced one
(trace=True and trace=False give bit-identical simulated times).

Three record kinds:

  * spans    — ``(rank, cat, name, t0, t1)`` intervals.  ``cat`` is one
    of ``compute`` (SimBLAS / NodeModel work), ``comm`` (SimMPI ops) or
    ``phase`` (application-level overlays: panel factorization, panel
    bcast, ...).  Spans emitted while a collective is open on the rank
    are flagged ``nested`` and excluded from breakdowns/critical path
    (the enclosing collective span carries the time).
  * instants — zero-width markers.
  * messages — one async record per p2p message, opened at ``isend``
    post and closed when the matching ``recv`` completes; these become
    Chrome async slices and the send->recv happens-before edges.

Happens-before edges recorded: per-rank program order (spans on one rank
are sequential by construction), send->recv (``deps`` on the recv span
point at the sender's post anchor), and collective membership (member
spans of one collective instance share a ``coll`` key; the analysis
treats the last-arriving member as the dependency of every other
member's exit).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class Span:
    __slots__ = ("sid", "rank", "cat", "name", "t0", "t1", "coll",
                 "nested", "deps", "args")

    def __init__(self, sid: int, rank: int, cat: str, name: str,
                 t0: float, t1: float, coll=None, nested: bool = False,
                 deps: Optional[List[int]] = None,
                 args: Optional[Dict[str, Any]] = None):
        self.sid = sid
        self.rank = rank
        self.cat = cat
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.coll = coll             # collective instance key, if any
        self.nested = nested         # emitted inside an open collective
        self.deps = deps or []       # sids this span happens-after
        self.args = args

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def __repr__(self):
        return (f"Span({self.sid}, r{self.rank}, {self.cat}:{self.name}, "
                f"[{self.t0:.3e}, {self.t1:.3e}])")


class Message:
    __slots__ = ("mid", "src", "dst", "nbytes", "tag", "t_post", "t_done",
                 "post_sid")

    def __init__(self, mid: int, src: int, dst: int, nbytes: float, tag,
                 t_post: float, post_sid: int):
        self.mid = mid
        self.src = src
        self.dst = dst
        self.nbytes = nbytes
        self.tag = tag
        self.t_post = t_post
        self.t_done: Optional[float] = None   # closed at recv completion
        self.post_sid = post_sid


class _NullRecorder:
    """Tracing-off singleton: every hook is a no-op behind ``enabled``."""
    enabled = False
    __slots__ = ()

    def complete(self, *a, **k):
        return -1

    def compute(self, *a, **k):
        return -1

    def instant(self, *a, **k):
        pass

    def coll_begin(self, *a, **k):
        return None

    def coll_end(self, *a, **k):
        pass

    def in_coll(self, rank) -> bool:
        return False

    def msg_post(self, *a, **k):
        pass

    def recv_done(self, *a, **k):
        return -1


NULL_RECORDER = _NullRecorder()


class TraceRecorder:
    enabled = True

    def __init__(self, engine):
        self.engine = engine
        self.spans: List[Span] = []
        self.instants: List[Tuple[int, str, float, Optional[dict]]] = []
        self.msgs: List[Message] = []
        self.coll_members: Dict[Any, List[int]] = {}   # coll key -> [sid]
        self._msg_by_event: Dict[int, Message] = {}    # id(Event) -> Message
        self._coll_depth: Dict[int, int] = {}          # rank -> open colls

    # ------------------------------------------------------------- state
    @property
    def makespan(self) -> float:
        return self.engine.now

    @property
    def now(self) -> float:
        return self.engine.now

    def in_coll(self, rank: int) -> bool:
        return self._coll_depth.get(rank, 0) > 0

    # ------------------------------------------------------------- spans
    def complete(self, rank: int, cat: str, name: str, t0: float, *,
                 t1: Optional[float] = None, coll=None,
                 nested: bool = False, deps: Optional[List[int]] = None,
                 args: Optional[Dict[str, Any]] = None) -> int:
        """Record a finished span [t0, t1] (t1 defaults to sim-now)."""
        sid = len(self.spans)
        self.spans.append(Span(sid, rank, cat, name, t0,
                               self.engine.now if t1 is None else t1,
                               coll=coll, nested=nested, deps=deps,
                               args=args))
        return sid

    def compute(self, rank: int, name: str, dur: float,
                args: Optional[Dict[str, Any]] = None) -> int:
        """A compute span starting now and lasting ``dur`` (the caller is
        about to ``yield dur``)."""
        now = self.engine.now
        return self.complete(rank, "compute", name, now, t1=now + dur,
                             args=args)

    def instant(self, rank: int, name: str,
                args: Optional[Dict[str, Any]] = None):
        self.instants.append((rank, name, self.engine.now, args))

    # ------------------------------------------------------- collectives
    def coll_begin(self, rank: int, name: str, op_id, group, nbytes):
        """Open a collective span on ``rank``.  Returns an opaque token
        for ``coll_end``.  The key (name, op_id) ties together the member
        spans of one collective instance across ranks."""
        depth = self._coll_depth.get(rank, 0)
        self._coll_depth[rank] = depth + 1
        key = (name, op_id)
        return (self.engine.now, key, depth > 0, len(group), nbytes)

    def coll_end(self, rank: int, token):
        t0, key, nested, n, nbytes = token
        self._coll_depth[rank] -= 1
        sid = self.complete(rank, "comm", key[0], t0, coll=key,
                            nested=nested,
                            args={"group": n, "bytes": nbytes})
        self.coll_members.setdefault(key, []).append(sid)

    # ---------------------------------------------------------- messages
    def msg_post(self, src: int, dst: int, nbytes: float, tag, event):
        """Called at isend post time; ``event`` is the transfer-complete
        Event whose identity the matching recv will present."""
        now = self.engine.now
        sid = self.complete(src, "comm", "isend", now, t1=now,
                            nested=self.in_coll(src),
                            args={"dst": dst, "bytes": nbytes})
        msg = Message(len(self.msgs), src, dst, nbytes, tag, now, sid)
        self.msgs.append(msg)
        self._msg_by_event[id(event)] = msg

    def recv_done(self, rank: int, src: int, t0: float, event) -> int:
        """Called when a recv's transfer completes: closes the message
        async slice and records the recv span with its send dep."""
        msg = self._msg_by_event.pop(id(event), None)
        deps = None
        nbytes = 0.0
        if msg is not None:
            msg.t_done = self.engine.now
            deps = [msg.post_sid]
            nbytes = msg.nbytes
        return self.complete(rank, "comm", "recv", t0,
                             nested=self.in_coll(rank), deps=deps,
                             args={"src": src, "bytes": nbytes})

    # ------------------------------------------------------------ export
    def to_chrome_json(self, path: Optional[str] = None):
        """Chrome trace-event JSON (loads in Perfetto / chrome://tracing);
        returns the dict, and writes it to ``path`` if given."""
        from .chrome import to_chrome_json
        return to_chrome_json(self, path)

    def summary(self) -> dict:
        """Makespan + per-rank breakdown + collective attribution +
        critical path, as one JSON-friendly dict."""
        from .analysis import summarize
        return summarize(self)
