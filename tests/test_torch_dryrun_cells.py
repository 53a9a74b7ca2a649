"""The port's dry-run records of the serving cells against the reference's
own records: every 16x16 decode_32k, prefill_32k and long_500k cell, and
the 2x16x16 decode_32k and long_500k cells.

One module-scoped child interpreter runs the reference's ``run_cell`` on
all of them at full width and depth (``repro/launch/dryrun.py`` forces
512 host devices itself), with the two jax aliases of
``tests/test_torch_dryrun.py`` (``enable_x64``, and ``make_mesh`` on Auto
axes) in the child only.  While it compiles, the port's ``run_cell``
counts the same cells here on meta tensors.  The two SSM prefills
(mamba2-780m and zamba2-2.7b at prefill_32k) take about a minute each to
count on a CPU, so they are left to the one-time check PERF.md records.

Held, per record, with ``chip_smoke.py``'s ``dryrun_gates`` at its
``DRYRUN_LIMITS``: the exact fields ``==``; FLOPs (and the
kernel-adjusted FLOPs) in [0.8, 1.25] of the reference's; bytes in
[1/3, 3] (kernel-adjusted where the reference's matcher removed tiles,
else raw); collective wire bytes per device, summed over every op kind,
in [1/3, 3]; ``predict_cell``'s step time in [1/3, 3].  The skip records
of the attention archs at long_500k equal the reference's, and no file
is written for them.
"""
import threading

import pytest

from repro_torch.configs import SHAPES, get_config, list_archs, \
    shape_applicable
from repro_torch.launch import dryrun
from torch_reference import MAKE_MESH_ALIAS, load_chip_smoke, \
    run_reference

REF_CHILD = MAKE_MESH_ALIAS + r"""
import contextlib, io, tempfile
from pathlib import Path
from repro.launch import dryrun
assert jax.device_count() == 512, jax.device_count()
out = Path(tempfile.mkdtemp())
for arch, shape, multi_pod in PAYLOAD:
    with contextlib.redirect_stdout(io.StringIO()):
        rec = dryrun.run_cell(arch, shape, multi_pod, out)
    OUT[dryrun._cell_out(out, arch, shape, multi_pod).name] = rec
OUT["files"] = sorted(p.name for p in out.iterdir())
"""


SCRIPT = load_chip_smoke()
SLOW = {("mamba2-780m", "prefill_32k"), ("zamba2-2.7b", "prefill_32k")}
CELLS = [(a, s, mp) for mp in (False, True) for a in list_archs()
         for s in (("prefill_32k", "decode_32k", "long_500k") if not mp
                   else ("decode_32k", "long_500k"))
         if (a, s) not in SLOW]
LIVE = [c for c in CELLS if shape_applicable(get_config(c[0]), SHAPES[c[1]])]
SKIPS = [c for c in CELLS if c not in LIVE]


def _key(cell):
    arch, shape, multi_pod = cell
    return f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """(the reference's records by key, the port's, the port's out dir,
    the files the reference wrote)."""
    box = {}

    def child():
        box["ref"] = run_reference(REF_CHILD, [list(c) for c in CELLS],
                                   timeout=900)
    thread = threading.Thread(target=child)
    thread.start()
    out = tmp_path_factory.mktemp("port")
    try:
        port = {_key(c): dryrun.run_cell(*c, out) for c in CELLS}
    finally:
        thread.join()
    ref = box["ref"]
    return ({_key(c): ref[_key(c) + ".json"] for c in CELLS}, port, out,
            ref["files"])


def _summary(rec):
    return dict(SCRIPT.dryrun_summary(rec), step_s=SCRIPT.dryrun_step_s(rec))


def test_the_cells():
    """22 records and 8 skips a mesh at 16x16 (the two SSM prefills left
    out), 12 records and 8 skips at 2x16x16."""
    assert len(LIVE) == 20 + 12 and len(SKIPS) == 16


@pytest.mark.parametrize("gate", ["exact", "flops", "bytes", "collectives",
                                  "step_s"])
@pytest.mark.parametrize("key", [_key(c) for c in LIVE])
def test_record_within_the_gates(records, key, gate):
    ref, port, out, files = records
    ratios, ok = SCRIPT.dryrun_gates(_summary(port[key]),
                                     _summary(ref[key]))[gate]
    assert ok, (key, gate, ratios)
    assert (out / f"{key}.json").exists() and f"{key}.json" in files


@pytest.mark.parametrize("key", [_key(c) for c in SKIPS])
def test_skip_record_equal(records, key):
    ref, port, out, files = records
    assert port[key] == ref[key] == dict(
        arch=key.split("__")[0], shape="long_500k", skipped=True,
        reason=dryrun.SKIP_REASON)
    assert not (out / f"{key}.json").exists()
    assert f"{key}.json" not in files
