"""SimMPI — MPI library model on the stream-level network (paper §III-B2).

Peer-to-peer ops run as flows on the network model (so contention is
emergent); eager vs rendezvous protocol by message size.  Collectives are
decomposed into p2p rounds mimicking OpenMPI/IntelMPI algorithm selection
(binomial / ring / recursive-doubling / Rabenseifner / pairwise) with the
same size-based switch points.

Every rank is a DES virtual thread; ``yield from`` any op to advance
simulated time.

Message matching is exact: tags are arbitrary hashable values and the
collectives use structured ``(op_id, round, ...)`` tuples directly.  (An
earlier revision truncated tags to 16-bit hashes, which could cross-match
two overlapping collectives on the same group — op_id hygiene is now a
tested invariant, see tests/test_simmpi.py.)

Tracing: when ``engine.trace`` is enabled every collective emits one span
per member rank (tagged with group size / bytes / algorithm op key),
every p2p message an async record from isend-post to recv-completion,
and blocking recvs a span carrying the send->recv happens-before edge.
The recorder never schedules engine events, so tracing does not perturb
simulated time.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from .engine import Engine, Event
from .hardware.network import Network

EAGER_LIMIT = 64 * 1024          # bytes: eager vs rendezvous
RDV_HANDSHAKE = 2                # extra half-RTTs for rendezvous


class SimMPI:
    def __init__(self, engine: Engine, network: Network, n_ranks: int,
                 rank_to_node=None, overhead: float = 5e-7):
        self.engine = engine
        self.net = network
        self.n = n_ranks
        self.rank_to_node = rank_to_node or (lambda r: r)
        self.overhead = overhead         # per-call software overhead (s)
        self._posted: Dict[Tuple[int, int, object], List[Event]] = {}
        self._recv_wait: Dict[Tuple[int, int, object], List[Event]] = {}
        self._coll_state: Dict = {}
        # rank -> node resolved once (the mapping is static by design);
        # isend is the hottest caller and skips the per-message calls
        self._node_of = [self.rank_to_node(r) for r in range(n_ranks)]
        # rendezvous handshake latency is a topology constant
        self._rdv_extra = RDV_HANDSHAKE * network.topo.base_latency
        self._p2p_msgs = 0
        self._p2p_bytes = 0.0
        self._colls = 0

    @property
    def counters(self) -> Dict:
        """Op counters as a dict (kept as plain attributes internally —
        attribute increments beat dict lookups in the isend hot path)."""
        return {"p2p_msgs": self._p2p_msgs, "p2p_bytes": self._p2p_bytes,
                "colls": self._colls}

    # ---------------------------------------------------------------- p2p
    def isend(self, src: int, dst: int, nbytes: float, tag=0) -> Event:
        """Post a send.  Returns the *sender-side* completion event:
        eager messages complete for the sender once buffered (overhead);
        rendezvous messages complete when the transfer finishes.  The
        receiver always waits for the transfer (see recv)."""
        self._p2p_msgs += 1
        self._p2p_bytes += nbytes
        eng = self.engine
        tren = eng.trace.enabled
        # fault hook: latency_jitter scales the per-message software
        # overhead (one attribute test when no faults are installed)
        overhead = self.overhead * eng.faults.latency_factor(src) \
            if eng.faults.enabled else self.overhead
        eager = nbytes <= EAGER_LIMIT
        transfer_done = eng.event()
        if src == dst:
            # schedule the bound set method — same dispatch, no
            # per-message closure allocation
            eng.call_at(eng.now + overhead, transfer_done.set, None)
            if tren:
                eng.trace.msg_post(src, dst, nbytes, tag, transfer_done)
            return transfer_done
        lat_extra = 0.0 if eager else self._rdv_extra
        node_of = self._node_of
        eng.call_at(eng.now + overhead + lat_extra, self._isend_go,
                    (node_of[src], node_of[dst], nbytes, transfer_done))
        if tren:
            eng.trace.msg_post(src, dst, nbytes, tag, transfer_done)

        # the matchbox entry carries the eager flag so recv knows the
        # sender kept no reference (eager senders get send_done instead)
        # and the transfer event can be recycled after delivery
        key = (src, dst, tag)
        entry = (transfer_done, eager)
        waiters = self._recv_wait.get(key)
        if waiters:
            waiters.pop(0).set(entry)
        else:
            self._posted.setdefault(key, []).append(entry)
        if eager:
            send_done = eng.event()
            eng.call_at(eng.now + overhead, send_done.set, None)
            return send_done
        return transfer_done

    def _isend_go(self, arg):
        """Deferred flow launch (fires after software overhead [+ rdv
        handshake]); the transfer event rides the flow-done event's
        waiters list directly — no per-message adapter."""
        src_node, dst_node, nbytes, transfer_done = arg
        flow_done = self.net.send(src_node, dst_node, nbytes)
        flow_done.waiters.append(transfer_done)

    def send(self, src: int, dst: int, nbytes: float, tag=0):
        """Generator: blocking send."""
        ev = self.isend(src, dst, nbytes, tag)
        yield ev

    def recv(self, src: int, dst: int, tag=0):
        """Generator: blocking receive — waits for the matching send's
        transfer to complete."""
        eng = self.engine
        tr = eng.trace
        t0 = eng.now if tr.enabled else 0.0
        key = (src, dst, tag)
        box = self._posted.get(key)
        if box:
            transfer, eager = box.pop(0)
        else:
            w = eng.event()
            self._recv_wait.setdefault(key, []).append(w)
            transfer, eager = yield w
            # w never escapes this generator (isend pops it from the
            # wait list before setting it), so it can go back to the
            # engine's event pool once we have resumed
            if eng.pooling:
                eng._recycle_event(w)
        yield transfer
        if tr.enabled:
            tr.recv_done(dst, src, t0, transfer)
        elif eager and eng.pooling:
            # eager transfers are invisible to the sender (it holds
            # send_done) and the recorder is off, so after delivery the
            # transfer event has no remaining references
            eng._recycle_event(transfer)

    def sendrecv(self, me: int, peer: int, nbytes: float, tag=0):
        ev = self.isend(me, peer, nbytes, tag)
        yield from self.recv(peer, me, tag)
        yield ev

    # --------------------------------------------------------- collectives
    # One generator per participating rank; all ranks call with the same
    # group and op_id (unique per call site x step — exact tuple tags mean
    # two in-flight collectives with different op_ids can never
    # cross-match).
    def _traced(self, name: str, rank: int, group: List[int], nbytes: float,
                op_id, impl):
        """Wrap a collective generator in a per-rank trace span; with
        tracing off the impl generator is returned bare (no wrapper
        frame on the resume path — yields are identical either way)."""
        tr = self.engine.trace
        if not tr.enabled:
            return impl
        return self._traced_span(name, rank, group, nbytes, op_id, impl, tr)

    def _traced_span(self, name, rank, group, nbytes, op_id, impl, tr):
        tok = tr.coll_begin(rank, name, op_id, group, nbytes)
        yield from impl
        tr.coll_end(rank, tok)

    def _gather_barrier(self, op_id, group: List[int], rank: int):
        """All ranks of `group` rendezvous; returns (event, is_root)."""
        st = self._coll_state.setdefault(op_id, {"arrived": 0,
                                                 "ev": self.engine.event()})
        st["arrived"] += 1
        if st["arrived"] == len(group):
            st["ev"].set()
            self._coll_state.pop(op_id, None)
        return st["ev"]

    def barrier(self, rank: int, group: List[int], op_id):
        return self._traced("barrier", rank, group, 0.0, op_id,
                            self._barrier_impl(rank, group, op_id))

    def _barrier_impl(self, rank: int, group: List[int], op_id):
        ev = self._gather_barrier(op_id, group, rank)
        yield ev
        # dissemination rounds: ceil(log2 n) latency exchanges
        n = len(group)
        rounds = max(1, math.ceil(math.log2(max(n, 2))))
        yield rounds * (self.net.topo.base_latency + self.overhead)

    def bcast(self, rank: int, root: int, group: List[int], nbytes: float,
              op_id):
        return self._traced("bcast", rank, group, nbytes, op_id,
                            self._bcast_impl(rank, root, group, nbytes,
                                             op_id))

    def _bcast_impl(self, rank: int, root: int, group: List[int],
                    nbytes: float, op_id):
        """Binomial tree for small msgs; scatter+ring-allgather for large
        (OpenMPI/van-de-Geijn switch at 512 KiB)."""
        self._colls += 1
        n = len(group)
        if n <= 1:
            return
        if nbytes < 512 * 1024:
            yield from self._bcast_binomial(rank, root, group, nbytes, op_id)
        else:
            # scatter (binomial, nbytes/n chunks) + ring allgather
            yield from self._bcast_binomial(rank, root, group, nbytes / n,
                                            (op_id, "scat"))
            yield from self.allgather(rank, group, nbytes / n,
                                      (op_id, "ag"))

    def _bcast_binomial(self, rank: int, root: int, group: List[int],
                        nbytes: float, op_id):
        n = len(group)
        idx = {r: i for i, r in enumerate(group)}
        me = (idx[rank] - idx[root]) % n
        rounds = math.ceil(math.log2(max(n, 2)))
        # virtual rank 0 is root; in round k, ranks < 2^k send to +2^k
        recv_round = None if me == 0 else int(math.floor(math.log2(me)))
        if recv_round is not None:
            src_v = me - (1 << recv_round)
            src = group[(src_v + idx[root]) % n]
            yield from self.recv(src, rank, tag=(op_id, me))
        start = 0 if me == 0 else recv_round + 1
        for k in range(start, rounds):
            dst_v = me + (1 << k)
            if dst_v < n:
                dst = group[(dst_v + idx[root]) % n]
                ev = self.isend(rank, dst, nbytes, tag=(op_id, dst_v))
                yield ev

    def allreduce(self, rank: int, group: List[int], nbytes: float, op_id):
        return self._traced("allreduce", rank, group, nbytes, op_id,
                            self._allreduce_impl(rank, group, nbytes,
                                                 op_id))

    def _allreduce_impl(self, rank: int, group: List[int], nbytes: float,
                        op_id):
        """Recursive doubling (small) / Rabenseifner reduce-scatter+allgather
        (large, switch 64 KiB)."""
        self._colls += 1
        n = len(group)
        if n <= 1:
            return
        idx = {r: i for i, r in enumerate(group)}
        me = idx[rank]
        if nbytes < 64 * 1024:
            rounds = math.ceil(math.log2(n))
            for k in range(rounds):
                peer_v = me ^ (1 << k)
                if peer_v < n:
                    peer = group[peer_v]
                    yield from self.sendrecv(rank, peer, nbytes,
                                             tag=(op_id, k))
        else:
            yield from self.reduce_scatter(rank, group, nbytes, (op_id, "rs"))
            yield from self.allgather(rank, group, nbytes / n, (op_id, "ag"))

    def reduce_scatter(self, rank: int, group: List[int], nbytes: float,
                       op_id):
        return self._traced("reduce_scatter", rank, group, nbytes, op_id,
                            self._reduce_scatter_impl(rank, group, nbytes,
                                                      op_id))

    def _reduce_scatter_impl(self, rank: int, group: List[int],
                             nbytes: float, op_id):
        """Ring reduce-scatter: n-1 rounds of nbytes/n to the neighbor."""
        n = len(group)
        if n <= 1:
            return
        idx = {r: i for i, r in enumerate(group)}
        me = idx[rank]
        nxt, prv = group[(me + 1) % n], group[(me - 1) % n]
        for k in range(n - 1):
            ev = self.isend(rank, nxt, nbytes / n, tag=(op_id, k, me))
            yield from self.recv(prv, rank, tag=(op_id, k, (me - 1) % n))
            yield ev

    def allgather(self, rank: int, group: List[int], nbytes_shard: float,
                  op_id):
        return self._traced("allgather", rank, group, nbytes_shard, op_id,
                            self._allgather_impl(rank, group, nbytes_shard,
                                                 op_id))

    def _allgather_impl(self, rank: int, group: List[int],
                        nbytes_shard: float, op_id):
        """Ring allgather: n-1 rounds forwarding shards."""
        n = len(group)
        if n <= 1:
            return
        idx = {r: i for i, r in enumerate(group)}
        me = idx[rank]
        nxt, prv = group[(me + 1) % n], group[(me - 1) % n]
        for k in range(n - 1):
            ev = self.isend(rank, nxt, nbytes_shard, tag=(op_id, k, me))
            yield from self.recv(prv, rank, tag=(op_id, k, (me - 1) % n))
            yield ev

    def alltoall(self, rank: int, group: List[int], nbytes_per_pair: float,
                 op_id):
        return self._traced("alltoall", rank, group, nbytes_per_pair, op_id,
                            self._alltoall_impl(rank, group,
                                                nbytes_per_pair, op_id))

    def _alltoall_impl(self, rank: int, group: List[int],
                       nbytes_per_pair: float, op_id):
        """Pairwise exchange, n-1 rounds: in round k send to (me+k) mod n
        and receive from (me-k) mod n, which covers every ordered pair for
        any group size (an XOR pairing silently skips rounds whenever
        me ^ k falls outside a non-power-of-two group)."""
        self._colls += 1
        n = len(group)
        idx = {r: i for i, r in enumerate(group)}
        me = idx[rank]
        for k in range(1, n):
            dst = group[(me + k) % n]
            src = group[(me - k) % n]
            ev = self.isend(rank, dst, nbytes_per_pair, tag=(op_id, k))
            yield from self.recv(src, rank, tag=(op_id, k))
            yield ev
