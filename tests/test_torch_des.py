"""Parity of the port's discrete-event stack (engine, network, SimMPI,
SimBLAS, HPLSim, TransformerStepSim, fault injection) with the JAX
package's, on the CPU.

The DES is pure Python, copied with only its imports changed, so the
tolerance is none: simulated times, event counts, logs and counters must
be bit-identical (compared with ``==``).  Each scenario below is one
source text, run once against ``repro`` in a child interpreter (where
``jax.experimental.enable_x64`` is aliased to ``jax.enable_x64`` so that
the reference imports; never in this process) and once against
``repro_torch`` here.  Floats cross as JSON, which round-trips them
exactly.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every scenario takes the plain-data arguments listed in ``CASES`` and
# returns JSON-able data.  ``PKG`` names the package it runs against.
SCENARIOS = r'''
import importlib
import math

def M(name):
    return importlib.import_module(PKG + "." + name)

def _fat_tree(n=16, bw=100e9 / 8, **kw):
    return M("core.hardware.topology").FatTreeTwoLevel(n, 4, 2, link_bw=bw,
                                                       **kw)

def _hpl(cfg_kw, topo=None):
    hpl = M("core.apps.hpl")
    node = M("core.hardware.node").local_node()
    res = hpl.HPLSim(hpl.HPLConfig(**cfg_kw), node,
                     topo if topo is not None else _fat_tree()).run()
    return [res.time_s, res.events, res.gflops]

# ------------------------------------------------------------ engine
def engine_wait_ordering():
    eng = M("core.engine").Engine()
    log = []
    def proc(name, waits):
        for w in waits:
            yield w
            log.append((name, eng.now))
    eng.spawn(proc("a", [1.0, 2.0]))
    eng.spawn(proc("b", [1.5]))
    eng.run_all()
    return [log, eng.event_count]

def engine_events_and_join():
    eng = M("core.engine").Engine()
    ev = eng.event()
    out = []
    def waiter():
        payload = yield ev
        out.append((eng.now, payload))
    def setter():
        yield 2.5
        ev.set("hello")
    w = eng.spawn(waiter())
    def joiner():
        yield w
        out.append(("joined", eng.now))
    eng.spawn(setter())
    eng.spawn(joiner())
    eng.run_all()
    return [out, eng.event_count]

def _one_link_net(cap, base_latency, routes):
    net_mod = M("core.hardware.network")
    eng = M("core.engine").Engine()
    links = [net_mod.Link(c) for c in cap]
    class T:
        pass
    T.base_latency = base_latency
    T.route = lambda self, s, d: [links[i] for i in routes(s, d)]
    return eng, net_mod.Network(eng, T())

def network_single_flow_rate():
    eng, net = _one_link_net([1e9], 1e-6, lambda s, d: [0])
    net.send(0, 1, 1e9)
    eng.run_all()
    return [eng.now, eng.event_count]

def network_fair_sharing_two_flows():
    eng, net = _one_link_net([1e9], 0.0, lambda s, d: [0])
    net.send(0, 1, 1e9)
    net.send(2, 3, 1e9)
    eng.run_all()
    return [eng.now, eng.event_count]

def network_contention_order():
    eng, net = _one_link_net([1e9], 0.0, lambda s, d: [0])
    log = []
    for i in range(8):
        ev = net.send(i, 100 + i, 1e8)
        def watch(name, ev=ev):
            yield ev
            log.append((name, eng.now))
        eng.spawn(watch(i))
    eng.run_all()
    return [log, eng.now, eng.event_count]

def network_components_independent():
    eng, net = _one_link_net([1e9, 2e9], 0.0,
                             lambda s, d: [0] if s == 0 else [1])
    d1 = net.send(0, 1, 1e9)
    d2 = net.send(2, 3, 1e9)
    times = {}
    def watch(name, ev):
        yield ev
        times[name] = eng.now
    eng.spawn(watch("f1", d1))
    eng.spawn(watch("f2", d2))
    eng.run_all()
    return [times, eng.event_count]

def network_shared_bottleneck():
    # tests/test_kernels.py's waterfill-vs-Network case
    eng, net = _one_link_net([10e9, 100e9, 2e9], 0.0,
                             lambda s, d: {0: [0, 1], 2: [0, 2]}[s])
    net.send(0, 1, 1e9)
    net.send(2, 3, 1e9)
    eng.run_all()
    return [eng.now, eng.event_count]

def topology_routes():
    topo = M("core.hardware.topology")
    out = []
    t = topo.FatTreeTwoLevel(64, 8, 4, link_bw=1e9)
    out.append([len(t.route(0, 1)), len(t.route(0, 13)),
                t.route(0, 13)[1] is t.edge_up[0][13 % 4],
                len(t.route(5, 5))])
    d = topo.Dragonfly(4, 4, 2, link_bw=1e9)
    out.append([len(d.route(0, 1)), len(d.route(0, 3)),
                len(d.route(0, d.p * d.a * 2 + 3))])
    r = topo.Torus((4, 4), link_bw=1e9)
    out.append([len(r.route(0, 1)), len(r.route(0, 3)), len(r.route(0, 5))])
    mp = topo.MultiPod([topo.Torus((2, 2), link_bw=1e9) for _ in range(2)],
                       4)
    out.append([any(l in mp.dcn_up for l in mp.route(1, 6)),
                len(mp.route(1, 6))])
    return out

# ------------------------------------------------------------- SimMPI
def _mpi(n=8, bw=12.5e9):
    eng = M("core.engine").Engine()
    topo = _fat_tree(max(n, 16), bw, base_latency=1e-6)
    net = M("core.hardware.network").Network(eng, topo)
    return eng, M("core.simmpi").SimMPI(eng, net, n)

def mpi_p2p(size_mult):
    eng, mpi = _mpi()
    size = 1024 if size_mult == 0 else size_mult * M("core.simmpi").EAGER_LIMIT
    t = {}
    def sender():
        yield from mpi.send(0, 1, size)
        t["send"] = eng.now
    def receiver():
        yield from mpi.recv(0, 1)
        t["recv"] = eng.now
    eng.spawn(sender())
    eng.spawn(receiver())
    eng.run_all()
    return [t, eng.event_count]

def _collective(n, op, nbytes):
    eng, mpi = _mpi(n)
    done = []
    def rank(r):
        if op == "bcast":
            yield from mpi.bcast(r, 0, list(range(n)), nbytes, op_id=("b",))
        else:
            yield from getattr(mpi, op)(r, list(range(n)), nbytes,
                                        op_id=(op, n))
        done.append((r, eng.now))
    for r in range(n):
        eng.spawn(rank(r))
    eng.run_all()
    return [done, eng.event_count, dict(mpi.counters)]

def mpi_allreduce(n):
    return _collective(n, "allreduce", 1 << 20)

def mpi_bcast(n):
    return _collective(n, "bcast", 4096)

def mpi_alltoall(n):
    return _collective(n, "alltoall", 65536 if n == 8 else 4096)

def mpi_overlapping_tags():
    eng, mpi = _mpi(2)
    size = 10 * M("core.simmpi").EAGER_LIMIT
    t = {}
    def sender():
        yield from mpi.send(0, 1, size, tag=("collA", 1))
        t["send_a"] = eng.now
        yield 5e-3
        yield from mpi.send(0, 1, 1024, tag=("collB", 1))
    def receiver():
        yield from mpi.recv(0, 1, tag=("collB", 1))
        t["recv_b"] = eng.now
        yield from mpi.recv(0, 1, tag=("collA", 1))
        t["recv_a"] = eng.now
    eng.spawn(sender())
    eng.spawn(receiver())
    eng.run_all()
    return [t, eng.event_count]

def mpi_interleaved_collectives():
    n = 4
    eng, mpi = _mpi(n)
    group = list(range(n))
    marks = {}
    def rank(r):
        if r == 0:
            yield 2e-3
        yield from mpi.allreduce(r, group, 1 << 10, op_id=("a",))
        t_a = eng.now
        yield from mpi.allreduce(r, group, 1 << 18, op_id=("b",))
        marks[r] = (t_a, eng.now)
    for r in range(n):
        eng.spawn(rank(r))
    eng.run_all()
    return [sorted(marks.items()), eng.event_count, dict(mpi.counters)]

# ---------------------------------------------------------------- HPL
def hpl_geometry(N, nb, P, Q, bcast="1ring"):
    return _hpl(dict(N=N, nb=nb, P=P, Q=Q, bcast=bcast))

def hpl_dragonfly():
    topo = M("core.hardware.topology").Dragonfly(4, 4, 2, link_bw=100e9 / 8)
    return _hpl(dict(N=2048, nb=128, P=4, Q=4), topo)

def hpl_constructor_forms():
    hpl = M("core.apps.hpl")
    plat = M("platforms").get_platform("bdw-local")
    cfg = plat.hpl_config(lookahead=0)
    stack = plat.des()
    runs = [hpl.HPLSim(cfg, plat).run(), hpl.HPLSim(cfg, stack).run(),
            hpl.HPLSim(cfg, stack.node, stack.topology,
                       ranks_per_node=stack.ranks_per_node,
                       mpi_overhead=stack.mpi_overhead).run()]
    return [[r.time_s, r.events] for r in runs]

def hpl_predict_des(name, kw):
    wl = M("workloads").get_workload("hpl", **kw)
    out = wl.predict_des(M("platforms").get_platform(name))
    return [out["time_s"], out["events"], out["gflops"]]

# ----------------------------------------------------- transformer step
def _step_workload(layers, tail):
    tf = M("core.apps.transformer")
    return tf.StepWorkload(
        layers=[tf.LayerWork(c, [tuple(x) for x in colls])
                for c, colls in layers],
        tail_collectives=[tuple(x) for x in tail])

def transformer_step(layers, tail, mesh, faults=None, trace=False):
    tf = M("core.apps.transformer")
    plat = M("platforms").get_platform("tpu-v5e-pod")
    spec = None if faults is None else M("faults").as_fault_spec(faults)
    sim = tf.TransformerStepSim.from_platform(
        _step_workload(layers, tail), plat, mesh=tuple(mesh), trace=trace,
        faults=spec)
    out = sim.run()
    keep = {k: v for k, v in out.items() if k != "trace"}
    return [keep, sim.engine.now, sim.engine.event_count]

# -------------------------------------------------------------- faults
HPL_SMALL = dict(N=1536, nb=128, P=2, Q=4, lookahead=0)

def _fault_spec(kind):
    F = M("faults")
    if kind == "acceptance":
        return (F.FaultSpec.straggler(rank=1, slowdown=2.0, seed=7)
                + F.FaultSpec.degraded_links(0.05, factor=0.5, seed=7))
    if kind == "replay":
        return (F.FaultSpec.degraded_links(0.2, factor=0.4, seed=99)
                + F.FaultSpec(faults=(F.Fault("latency_jitter", sigma=0.3),))
                + F.FaultSpec(faults=(F.Fault("link_flap", link_frac=0.1,
                                              factor=0.5, period=1e-3,
                                              duty=0.5, cycles=3),)))
    if kind == "replay_seed100":
        import dataclasses
        return dataclasses.replace(_fault_spec("replay"), seed=100)
    if kind == "fail_stop_hpl":
        return F.FaultSpec.fail_stop(rank=2, at=1e-4)
    if kind == "fail_stop_rank0":
        return F.FaultSpec.fail_stop(rank=0)
    if kind == "straggler3":
        return F.FaultSpec.straggler(rank=3, slowdown=3.0)
    if kind == "none":
        return F.NO_FAULTS
    if kind == "empty":
        return F.FaultSpec()
    raise KeyError(kind)

def hpl_faults(kind):
    wl = M("workloads").get_workload("hpl", **HPL_SMALL)
    plat = M("platforms").get_platform("bdw-local")
    faults = None if kind is None else _fault_spec(kind)
    out = wl.predict_des(plat, faults=faults)
    return sorted(out.items())

def hpl_faults_traced(kind):
    from_pkg = M("trace")
    wl = M("workloads").get_workload("hpl", **HPL_SMALL)
    app = wl.des_app(M("platforms").get_platform("bdw-local"), trace=True,
                     faults=_fault_spec(kind))
    res = app.run()
    summ = app.engine.trace.summary()
    doc = from_pkg.to_chrome_json(app.engine.trace)
    from_pkg.validate_chrome_events(doc)
    tids = sorted({e["args"]["name"] for e in doc["traceEvents"]
                   if e.get("ph") == "M" and e.get("name") == "thread_name"})
    return [app.engine.now, res.events, summ, tids]

def transformer_faults(layers, tail, mesh, kind):
    return transformer_step(layers, tail, mesh,
                            faults=_fault_spec(kind).to_dict())

def engine_wall_deadline():
    E = M("core.engine")
    def ticker():
        while True:
            yield 1e-6
    eng = E.Engine()
    eng.spawn(ticker())
    eng.set_wall_deadline(0.05)
    try:
        eng.run_all()
        raised = None
    except E.SimWallDeadline as exc:
        raised = ["SimWallDeadline", "wall" in str(exc)]
    eng2 = E.Engine()
    def finite():
        for _ in range(10):
            yield 1e-6
    eng2.spawn(finite())
    eng2.run_all()
    return [raised, eng2.now, eng2.event_count]

def engine_process_error():
    E = M("core.engine")
    def boom():
        yield 1e-3
        raise KeyError("lost rendezvous")
    eng = E.Engine()
    eng.spawn(boom(), name="rank 7")
    try:
        eng.run_all()
        return None
    except E.ProcessError as exc:
        return [str(exc), exc.process, exc.sim_time, exc.pending_events,
                type(exc.__cause__).__name__]
'''

TF_LAYERS = [[1e-3, [["all-reduce", float(1 << 20), "model"]]]] * 3
TF_TAIL = [["all-reduce", float(1 << 22), "data"]]

# (case id, scenario, arguments)
CASES = [
    ("engine_wait_ordering", "engine_wait_ordering", []),
    ("engine_events_and_join", "engine_events_and_join", []),
    ("network_single_flow_rate", "network_single_flow_rate", []),
    ("network_fair_sharing_two_flows", "network_fair_sharing_two_flows", []),
    ("network_contention_order", "network_contention_order", []),
    ("network_components_independent", "network_components_independent",
     []),
    ("network_shared_bottleneck", "network_shared_bottleneck", []),
    ("topology_routes", "topology_routes", []),
    ("mpi_p2p_eager", "mpi_p2p", [0]),
    ("mpi_p2p_rendezvous", "mpi_p2p", [10]),
    ("mpi_allreduce_2", "mpi_allreduce", [2]),
    ("mpi_allreduce_4", "mpi_allreduce", [4]),
    ("mpi_allreduce_8", "mpi_allreduce", [8]),
    ("mpi_bcast_4", "mpi_bcast", [4]),
    ("mpi_bcast_16", "mpi_bcast", [16]),
    ("mpi_alltoall_8", "mpi_alltoall", [8]),
    ("mpi_alltoall_3", "mpi_alltoall", [3]),
    ("mpi_alltoall_5", "mpi_alltoall", [5]),
    ("mpi_alltoall_6", "mpi_alltoall", [6]),
    ("mpi_alltoall_7", "mpi_alltoall", [7]),
    ("mpi_overlapping_tags", "mpi_overlapping_tags", []),
    ("mpi_interleaved_collectives", "mpi_interleaved_collectives", []),
    # tests/test_hpl_sim.py:20 and :34, the partial trailing panel (:75)
    ("hpl_2048_4x4", "hpl_geometry", [2048, 128, 4, 4]),
    ("hpl_4096_2x8", "hpl_geometry", [4096, 128, 2, 8]),
    ("hpl_4096_4x4", "hpl_geometry", [4096, 128, 4, 4]),
    ("hpl_partial_1000", "hpl_geometry", [1000, 96, 2, 2]),
    ("hpl_floor_960", "hpl_geometry", [960, 96, 2, 2]),
    # tests/test_distributed_exec.py:105 and :118
    ("hpl_dragonfly", "hpl_dragonfly", []),
    ("hpl_bcast_1ring", "hpl_geometry", [2048, 128, 2, 8, "1ring"]),
    ("hpl_bcast_long", "hpl_geometry", [2048, 128, 2, 8, "long"]),
    ("hpl_constructor_forms", "hpl_constructor_forms", []),
    ("hpl_predict_des_bdw_local", "hpl_predict_des", ["bdw-local", {}]),
    ("transformer_step_4x4", "transformer_step",
     [TF_LAYERS, TF_TAIL, [4, 4]]),
    # tests/test_faults.py:110, :120, :129, :211, :219, :404, :427
    ("faults_hpl_none", "hpl_faults", [None]),
    ("faults_hpl_no_faults", "hpl_faults", ["none"]),
    ("faults_hpl_empty_spec", "hpl_faults", ["empty"]),
    ("faults_transformer_none", "transformer_step",
     [TF_LAYERS, TF_TAIL, [2, 4]]),
    ("faults_hpl_seeded_replay", "hpl_faults", ["replay"]),
    ("faults_hpl_seed_100", "hpl_faults", ["replay_seed100"]),
    ("faults_hpl_acceptance", "hpl_faults", ["acceptance"]),
    ("faults_hpl_acceptance_traced", "hpl_faults_traced", ["acceptance"]),
    ("faults_hpl_fail_stop", "hpl_faults", ["fail_stop_hpl"]),
    ("faults_transformer_acceptance", "transformer_faults",
     [TF_LAYERS, TF_TAIL, [2, 4], "acceptance"]),
    ("faults_transformer_straggler", "transformer_faults",
     [TF_LAYERS, TF_TAIL, [2, 4], "straggler3"]),
    ("faults_transformer_fail_stop", "transformer_faults",
     [TF_LAYERS, TF_TAIL, [2, 4], "fail_stop_rank0"]),
    ("engine_wall_deadline", "engine_wall_deadline", []),
    ("engine_process_error", "engine_process_error", []),
]

CHILD = r"""
import json, sys
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
ns = {"PKG": "repro"}
pay = json.loads(sys.stdin.read())
exec(pay["scenarios"], ns)
out = {cid: ns[fn](*args) for cid, fn, args in pay["cases"]}
print(json.dumps(out))
"""


def _plain(x):
    """Tuples as lists, dict keys as strings: what a JSON round trip
    gives, so both sides compare in one form."""
    return json.loads(json.dumps(x))


def _run(pkg, fn, args):
    ns = {"PKG": pkg}
    exec(SCENARIOS, ns)
    return _plain(ns[fn](*args))


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])
    payload = {"scenarios": SCENARIOS, "cases": CASES}
    proc = subprocess.run([sys.executable, "-c", CHILD],
                          input=json.dumps(payload), capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cid,fn,args", CASES, ids=[c[0] for c in CASES])
def test_des_bit_identical_to_reference(reference, cid, fn, args):
    ours = _run("repro_torch", fn, args)
    ref = reference[cid]
    if cid == "engine_wall_deadline":
        # the wall-clock budget decides how many ticks ran; the outcome
        # and the bounded run after it must agree
        assert ours[0] == ref[0] == ["SimWallDeadline", True]
        assert ours[1:] == ref[1:]
        return
    assert ours == ref


def test_des_reference_values_are_the_published_ones(reference):
    """The port's bdw-local DES equals the reference's known values (and
    the bcast variants finish within the reference test's bound)."""
    t, events, _ = reference["hpl_predict_des_bdw_local"]
    assert (t, events) == (0.05864729600365412, 10597)
    ours = _run("repro_torch", "hpl_predict_des", ["bdw-local", {}])
    assert ours[:2] == [0.05864729600365412, 10597]
    assert (_run("repro_torch", "hpl_geometry", [2048, 128, 2, 8, "long"])[0]
            < 1.5 * _run("repro_torch", "hpl_geometry",
                         [2048, 128, 2, 8, "1ring"])[0])


def test_waterfill_matches_des_network():
    """The port's max-min fair allocation (``waterfill``, plain path on
    the CPU) and its DES Network's progressive filling agree on the
    shared-bottleneck case of tests/test_kernels.py (rtol 1e-4, that
    test's bound): flow 2 is held at its 2 GB/s link, flow 1 gets the
    remaining 8 GB/s of the shared 10 GB/s link."""
    import numpy as np
    import torch

    from repro_torch.core.engine import Engine
    from repro_torch.core.hardware.network import Link, Network
    from repro_torch.kernels.maxmin_fair import waterfill

    shared, a, b = Link(10e9), Link(100e9), Link(2e9)

    class Topo:
        base_latency = 0.0

        def route(self, s, d):
            return {(0, 1): [shared, a], (2, 3): [shared, b]}[(s, d)]

    eng = Engine()
    net = Network(eng, Topo())
    net.send(0, 1, 1e9)
    net.send(2, 3, 1e9)
    eng.run(until=0.0)              # both flows started, none finished
    des_rates = [f.rate for f in net.flows]
    eng.run_all()
    # flow 1 ends at 1/8 s, flow 2 runs on at 2 GB/s: done at 0.5 s
    assert abs(eng.now - 0.5) < 0.02, eng.now
    adj = torch.tensor([[1, 1, 0], [1, 0, 1]], dtype=torch.int8)
    caps = torch.tensor([10e9, 100e9, 2e9], dtype=torch.float32)
    rates = waterfill(adj, caps).numpy()
    np.testing.assert_allclose(rates, [8e9, 2e9], rtol=1e-4)
    np.testing.assert_allclose(rates, des_rates, rtol=1e-4)
