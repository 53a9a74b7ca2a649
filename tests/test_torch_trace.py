"""Parity of the port's trace subsystem (recorder, Chrome export,
critical-path analysis) with the JAX package's, on the CPU.

Like the DES it instruments, the trace code is pure Python copied with
only its imports changed, so there is no tolerance: summaries, critical
paths, breakdowns and Chrome documents must equal the reference's
exactly (compared with ``==`` after a JSON round trip, which keeps
floats exact).  The reference runs the same scenario text in a child
interpreter that aliases ``jax.experimental.enable_x64`` to
``jax.enable_x64`` (never in this process).
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENARIOS = r'''
import importlib

def M(name):
    return importlib.import_module(PKG + "." + name)

def _hpl_sim(trace, N=1024, nb=128, P=2, Q=4, bcast="1ring"):
    hpl = M("core.apps.hpl")
    topo = M("core.hardware.topology").FatTreeTwoLevel(
        max(P * Q, 16), 4, 2, link_bw=100e9 / 8)
    cfg = hpl.HPLConfig(N=N, nb=nb, P=P, Q=Q, bcast=bcast)
    return hpl.HPLSim(cfg, M("core.hardware.node").local_node(), topo,
                      trace=trace)

def _spans(spans):
    return [[s.sid, s.rank, s.cat, s.name, s.t0, s.t1, s.nested,
             list(s.deps)] for s in spans]

def hpl_traced(N, nb, P, Q, bcast):
    tr_mod = M("trace")
    off = _hpl_sim(False, N, nb, P, Q, bcast)
    r_off = off.run()
    sim = _hpl_sim(True, N, nb, P, Q, bcast)
    res = sim.run()
    cp = tr_mod.critical_path(sim.trace)
    return {
        "untraced": [r_off.time_s, r_off.events,
                     off.trace is tr_mod.NULL_RECORDER, r_off.trace is None],
        "traced": [res.time_s, res.events],
        "summary": sim.trace.summary(),
        "critical_path": [cp.length_s, cp.makespan_s, _spans(cp.spans),
                          cp.by_cat, cp.by_name],
        "rank_breakdown": tr_mod.rank_breakdown(sim.trace),
        "spans": _spans(sim.trace.spans),
        "chrome": tr_mod.to_chrome_json(sim.trace),
    }

def serial_chain():
    eng = M("core.engine").Engine(trace=True)
    tr = eng.trace
    def proc():
        for i, dur in enumerate([0.5, 0.25, 1.0, 0.125]):
            tr.compute(0, f"step{i}", dur)
            yield dur
    eng.spawn(proc())
    makespan = eng.run_all()
    cp = M("trace").critical_path(tr)
    return [makespan, cp.length_s, _spans(cp.spans),
            M("trace").rank_breakdown(tr)]

def send_recv_edge():
    eng = M("core.engine").Engine(trace=True)
    topo = M("core.hardware.topology").FatTreeTwoLevel(16, 4, 2, link_bw=1e9)
    net = M("core.hardware.network").Network(eng, topo)
    mpi = M("core.simmpi").SimMPI(eng, net, 2)
    tr = eng.trace
    def r0():
        yield from mpi.recv(1, 0, tag="x")
        tr.compute(0, "after", 1e-4)
        yield 1e-4
    def r1():
        tr.compute(1, "work", 5e-3)
        yield 5e-3
        yield from mpi.send(1, 0, 4 * 1024 * 1024, tag="x")
    eng.spawn(r0())
    eng.spawn(r1())
    makespan = eng.run_all()
    cp = M("trace").critical_path(tr)
    return [makespan, cp.length_s, [(s.rank, s.name) for s in cp.spans]]

def transformer_traced():
    tf = M("core.apps.transformer")
    wl = tf.StepWorkload(
        layers=[tf.LayerWork(1e-3, [("all-reduce", 1 << 20, "model")])] * 3,
        tail_collectives=[("all-reduce", 1 << 22, "data")])
    sim = tf.TransformerStepSim(wl, mesh=(4, 4), trace=True)
    out = sim.run()
    off = tf.TransformerStepSim(wl, mesh=(4, 4)).run()
    return [out["step_s"], out["events"], off["step_s"], off["events"],
            sim.trace.summary(), M("trace").to_chrome_json(sim.trace)]

def platform_des_trace_flag():
    hpl = M("core.apps.hpl")
    plat = M("platforms").get_platform("bdw-local")
    cfg = plat.hpl_config(N=512, nb=64, P=2, Q=2)
    res = hpl.HPLSim(cfg, plat.des(trace=True)).run()
    default_off = (hpl.HPLSim(cfg, plat).engine.trace
                   is M("trace").NULL_RECORDER)
    return [res.time_s, res.events, len(res.trace.spans), default_off,
            res.trace.summary()]
'''

# (case id, scenario, arguments).  hpl_1024_2x4 is tests/test_trace.py's
# run; the others widen the geometry (partial last panel, the long bcast,
# P = 1, a 4 x 4 grid).
CASES = [
    ("hpl_1024_2x4", "hpl_traced", [1024, 128, 2, 4, "1ring"]),
    ("hpl_ragged_long", "hpl_traced", [1000, 96, 3, 2, "long"]),
    ("hpl_p1", "hpl_traced", [640, 64, 1, 3, "1ring"]),
    ("hpl_2048_4x4", "hpl_traced", [2048, 128, 4, 4, "1ring"]),
    ("serial_chain", "serial_chain", []),
    ("send_recv_edge", "send_recv_edge", []),
    ("transformer_traced", "transformer_traced", []),
    ("platform_des_trace_flag", "platform_des_trace_flag", []),
]
HPL_CASES = [c for c in CASES if c[1] == "hpl_traced"]

CHILD = r"""
import json, sys
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
ns = {"PKG": "repro"}
pay = json.loads(sys.stdin.read())
exec(pay["scenarios"], ns)
print(json.dumps({cid: ns[fn](*args) for cid, fn, args in pay["cases"]}))
"""


def _plain(x):
    return json.loads(json.dumps(x))


def _ours(fn, args):
    ns = {"PKG": "repro_torch"}
    exec(SCENARIOS, ns)
    return ns[fn](*args)


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-c", CHILD],
        input=json.dumps({"scenarios": SCENARIOS, "cases": CASES}),
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ours():
    return {cid: _ours(fn, args) for cid, fn, args in CASES}


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_trace_equal_to_reference(reference, ours, cid):
    assert _plain(ours[cid]) == reference[cid]


@pytest.mark.parametrize("cid", [c[0] for c in HPL_CASES])
def test_traced_equals_untraced(ours, cid):
    """Tracing perturbs nothing: the same simulated time and event count
    as the untraced run, and the untraced run carries the null recorder."""
    out = ours[cid]
    t_off, ev_off, null_rec, no_trace = out["untraced"]
    assert null_rec and no_trace
    assert out["traced"] == [t_off, ev_off]
    assert out["summary"]["makespan_s"] == t_off


@pytest.mark.parametrize("cid,args", [(c[0], c[2]) for c in HPL_CASES],
                         ids=[c[0] for c in HPL_CASES])
def test_chrome_export_validates_and_round_trips(tmp_path, ours, cid, args):
    from repro_torch.core.apps.hpl import HPLConfig, HPLSim
    from repro_torch.core.hardware.node import local_node
    from repro_torch.core.hardware.topology import FatTreeTwoLevel
    from repro_torch.trace import REQUIRED_KEYS, validate_chrome_events

    N, nb, P, Q, bcast = args
    topo = FatTreeTwoLevel(max(P * Q, 16), 4, 2, link_bw=100e9 / 8)
    sim = HPLSim(HPLConfig(N=N, nb=nb, P=P, Q=Q, bcast=bcast), local_node(),
                 topo, trace=True)
    res = sim.run()
    path = tmp_path / "trace.json"
    doc = sim.trace.to_chrome_json(str(path))
    validate_chrome_events(doc)
    on_disk = json.loads(path.read_text())
    assert on_disk["traceEvents"] == doc["traceEvents"]
    assert on_disk == _plain(ours[cid]["chrome"])
    evs = doc["traceEvents"]
    assert all(k in ev for ev in evs for k in REQUIRED_KEYS)
    assert {"M", "X"} <= {ev["ph"] for ev in evs}
    assert len([ev for ev in evs if ev["name"] == "thread_name"]) == P * Q
    for ev in evs:
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
            assert 0 <= ev["ts"] <= res.time_s * 1e6 * (1 + 1e-9)


def test_validate_chrome_events_rejects_bad_docs():
    from repro_torch.trace import validate_chrome_events
    with pytest.raises(ValueError):
        validate_chrome_events({})
    with pytest.raises(ValueError):
        validate_chrome_events({"traceEvents": [{"ph": "X", "ts": 0}]})
    with pytest.raises(ValueError):
        validate_chrome_events({"traceEvents": [
            {"ph": "X", "ts": "zero", "pid": 0, "tid": 0, "name": "n",
             "dur": 1}]})


def test_critical_path_invariants(ours):
    """tests/test_trace.py's invariants hold on the port: the path is no
    longer than the makespan and explains most of it; a serial chain's
    path is the whole chain; a send/recv edge routes through the
    sender."""
    out = ours["hpl_1024_2x4"]
    length, makespan = out["critical_path"][:2]
    assert 0.5 * makespan < length <= makespan * (1 + 1e-9)
    chain_makespan, chain_len, chain_spans, _ = ours["serial_chain"]
    assert chain_len == pytest.approx(chain_makespan, rel=1e-12)
    assert len(chain_spans) == 4
    edge_makespan, edge_len, names = ours["send_recv_edge"]
    assert (1, "work") in names and (0, "after") in names
    assert 0.95 * edge_makespan < edge_len <= edge_makespan * (1 + 1e-9)
