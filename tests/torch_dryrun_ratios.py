"""Port / reference ratios of dry-run records, cell by cell, as a table.

    PYTHONPATH=src python tests/torch_dryrun_ratios.py [--src DIR]
        [--batch B]

One child interpreter writes the reference's records of every cell of
every arch and shape on both meshes (``repro.launch.dryrun.run_cell``,
jax 0.9.0's two aliases set in it, as ``tests/test_torch_dryrun_cells.py``
does); six worker processes count the port's records of the same cells
with the ``repro_torch``
found under ``--src`` (default this checkout's ``src``; another
checkout's, to read an earlier tree).  Each record is held with
``chip_smoke.py``'s ``dryrun_gates`` at its ``DRYRUN_LIMITS``, and one
markdown row a cell is printed: the FLOPs (and kernel-adjusted FLOPs),
bytes, collective and step-time ratios and the gates that failed.  Skip
records are compared ``==``.  ``--batch`` gives every shape that global
batch in both packages (decode at a batch of one, say, which leaves the
data axis idle as long_500k does).  The 80 cells take ~3 min on an 8-core
CPU (the two SSM prefills and three SSM and hybrid train cells ~40-60 s
each).
"""
import argparse
import contextlib
import io
import multiprocessing
import os
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from torch_reference import MAKE_MESH_ALIAS, load_chip_smoke, \
    run_reference  # noqa: E402

REF_CHILD = MAKE_MESH_ALIAS + r"""
import contextlib, dataclasses, io, tempfile
from pathlib import Path
import repro.configs as configs
from repro.launch import dryrun
if PAYLOAD["batch"]:
    for name, shape in list(configs.SHAPES.items()):
        configs.SHAPES[name] = dataclasses.replace(
            shape, global_batch=PAYLOAD["batch"])
out = Path(tempfile.mkdtemp())
for arch, shape, multi_pod in PAYLOAD["cells"]:
    with contextlib.redirect_stdout(io.StringIO()):
        rec = dryrun.run_cell(arch, shape, multi_pod, out)
    OUT[f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"] = rec
"""


def _init(src, batch):
    sys.path.insert(0, src)
    if batch:
        import dataclasses
        import repro_torch.configs as configs
        for name, shape in list(configs.SHAPES.items()):
            configs.SHAPES[name] = dataclasses.replace(shape,
                                                       global_batch=batch)


def _port(cell):
    from repro_torch.launch import dryrun
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        return dryrun.run_cell(*cell, tmp)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--batch", type=int, default=0,
                    help="the global batch of every shape (0: its own)")
    args = ap.parse_args(argv)
    from repro_torch.configs import SHAPES, list_archs
    script = load_chip_smoke()
    cells = [(a, s, mp) for mp in (False, True) for a in list_archs()
             for s in SHAPES]
    keys = [f"{a}__{s}__{'2x16x16' if mp else '16x16'}"
            for a, s, mp in cells]
    # spawned, so each worker imports repro_torch from --src
    with ProcessPoolExecutor(6,
                             mp_context=multiprocessing.get_context("spawn"),
                             initializer=_init,
                             initargs=(os.path.abspath(args.src),
                                       args.batch)) as ex:
        port = ex.map(_port, cells)
        ref = run_reference(REF_CHILD, {"cells": [list(c) for c in cells],
                                        "batch": args.batch}, timeout=1800)
        port = dict(zip(keys, port))
    print("| cell | FLOPs | bytes | collectives | step_s | failed |")
    print("| --- | --- | --- | --- | --- | --- |")
    for key in keys:
        got, want = port[key], ref[key]
        if want.get("skipped") or got.get("skipped"):
            print(f"| {key} | skip | | | | "
                  f"{'' if got == want else 'skip record'} |")
            continue
        gates = script.dryrun_gates(
            dict(script.dryrun_summary(got), step_s=script.dryrun_step_s(got)),
            dict(script.dryrun_summary(want),
                 step_s=script.dryrun_step_s(want)))
        cols = [", ".join(f"{r:.3f}" for r in gates[g][0])
                for g in ("flops", "bytes", "collectives", "step_s")]
        failed = ", ".join(g for g, (_, ok) in gates.items() if not ok)
        print(f"| {key} | " + " | ".join(cols) + f" | {failed} |",
              flush=True)


if __name__ == "__main__":
    main()
