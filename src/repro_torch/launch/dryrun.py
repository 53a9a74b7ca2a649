"""Dry-run: describe one (arch x shape x mesh) cell as the reference's
dry-run record, without a mesh, a process group or a card.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k \\
        --multi-pod
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k \\
        --set force_scheme=dp --tag dp
    python -m repro_torch.launch.dryrun --all [--force] --out DIR

Port of ``repro.launch.dryrun``: ``run_cell``, ``sweep`` and the CLI.  The
reference lowers and compiles the cell on 256 or 512 forced host devices
and reads FLOPs, bytes and collectives off the partitioned HLO.  The
port has no XLA program.  Its record comes from the port's own step
(``make_train_step``, ``Model.prefill`` or ``Model.decode``) run once on
meta tensors under ``roofline.count``, which adds up FLOPs and bytes op
by op, and from ``sharding.collectives``, which writes the step's
collectives out from the sharding rules.  Nothing is allocated, no
device is touched and nothing global is set up in the caller's process.

The record has the reference's keys.  ``persistent_bytes_per_device`` is
``sharding.sharded_bytes`` over the same trees the reference sums.
``memory_analysis`` and ``cost_analysis`` take the reference's own form
for an unavailable analysis, ``{"error": ...}``, and ``compile_s`` is
null: there is nothing compiled.  The count's wall time is ``count_s``.
A decode step is counted on a copy of the cache: the reference's decode
is a function from a cache to a new one, the port's writes its cache in
place, and the record describes the function.

The count is one device's: the work over the devices that hold distinct
shares of it (``work_replicas``), each persistent leaf (the parameters,
the cache, the optimizer state) and its views and copies at the share
``shard_shape`` gives it under the cell's rules, and the decode value
product split as the reference's partitioner splits it (``value_split``).

``--all`` is the reference's sweep (``sweep``): every arch x shape x
mesh, one child process a cell, serially; ``--force`` redoes the cells
it finds recorded.  Without ``--all``, ``--force`` does nothing, as in
the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import traceback
from pathlib import Path
from typing import Callable, Optional

import torch

from repro_torch._tree import map_with_keys
from repro_torch.configs import get_config, get_shape, shape_applicable
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.api import (abstract_cache, abstract_params,
                                    abstract_state, input_specs)
from repro_torch.roofline import count as counting
from repro_torch.roofline.analysis import roofline_terms
from repro_torch.sharding import collectives
from repro_torch.sharding.specs import (_axes, leaf_shards, legalize,
                                        make_rules, resolve, sharded_bytes,
                                        tree_shardings)
from repro_torch.train.step import make_train_step, state_specs

_NO_PROGRAM = ("no XLA program: repro_torch counts its own step on meta "
               "tensors (repro_torch.roofline.count)")
SKIP_REASON = "long_500k requires sub-quadratic attention (see DESIGN.md §5)"
# the sweep's own skip record says it otherwise
SWEEP_SKIP_REASON = "long_500k needs sub-quadratic attention"


def _cell_out(out_dir: Path, arch: str, shape: str, multi_pod: bool,
              tag: str = "") -> Path:
    mesh = "2x16x16" if multi_pod else "16x16"
    suffix = f"__{tag}" if tag else ""
    return out_dir / f"{arch}__{shape}__{mesh}{suffix}.json"


def _bf16_params(params):
    """The floating leaves as bfloat16 meta tensors (serving weights)."""
    return map_with_keys(
        lambda _, p: (torch.empty(p.shape, dtype=torch.bfloat16,
                                  device="meta")
                      if p.is_floating_point() else p), params)


def _step(cfg, shape, model):
    """The cell's step as a function of no arguments, its parameters and
    the trees the reference sums for the persistent bytes, as
    ``(fn, params, [(abstract tree, logical specs), ...])``."""
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        step_fn, _ = make_train_step(cfg, device="meta")
        state = abstract_state(cfg)
        # the update reads the step count once on the host (a 0-d int32,
        # step 0's); every other leaf stays on meta
        opt = dict(state.opt, count=torch.zeros((), dtype=torch.int32))
        run = state._replace(opt=opt)
        return ((lambda: step_fn(run, batch)), state.params,
                [(state, state_specs(cfg, model))])
    params = _bf16_params(abstract_params(cfg))
    persistent = [(params, model.param_specs()),
                  (abstract_cache(cfg, shape), model.cache_specs())]
    if shape.kind == "prefill":
        return ((lambda: model.prefill(params, batch,
                                       max_len=shape.seq_len)),
                params, persistent)
    # the persistent cache's own leaves, with the Python int ``len`` that
    # ``Model.decode`` counts with
    cache = dict(persistent[1][0], len=0)

    def decode():
        copy = map_with_keys(lambda _, v: v.clone()
                             if isinstance(v, torch.Tensor) else v, cache)
        return model.decode(params, copy, batch["tokens"])
    return decode, params, persistent


def _batch_axes(rules, mesh, shape) -> tuple:
    """The mesh axes the cell's batch splits over (``dp``, legalized)."""
    return _axes(legalize(resolve(("dp",), rules), (shape.global_batch,),
                          mesh)[0])


def work_replicas(rules, mesh, shape) -> int:
    """Devices that hold each share of the step's work: the product of
    the mesh axes that split none of it.  The batch splits over the
    ``dp`` axes that divide it, the model dims over the tensor-parallel,
    sequence and (decode) cache-sequence axes; ``make_rules`` drops the
    batch axes for a batch they do not divide (long_500k's one
    sequence), and the work is then repeated over them."""
    split = set(_batch_axes(rules, mesh, shape))
    for name in ("tp", "tp_kv", "tp_rep", "sp") + (
            ("kv_seq",) if shape.kind == "decode" else ()):
        split.update(rules.get(name, ()))
    return math.prod(n for a, n in mesh.shape.items() if a not in split)


def value_split(cfg, shape, rules, mesh) -> Optional[Callable]:
    """The reference's partitioner in a decode step whose batch leaves
    the ``data`` axis idle, as its HLO shows: every head's scores are
    computed over the device's part of the cache (its sequence on the
    ``kv_seq`` axes), and the product of the probabilities with the
    values then splits the tensor-parallel heads over ``data``.  Returns
    ``(func, args) -> parts`` for ``count``'s ``split`` (the value
    product, the one that contracts over the cache's length, into
    ``data``'s size), or None where no product splits so."""
    if shape.kind != "decode" or cfg.attention_free or \
            "data" in _batch_axes(rules, mesh, shape):
        return None
    heads = (cfg.n_kv_heads if rules["tp_kv"] else
             cfg.n_heads // cfg.n_kv_heads if rules["tp_rep"] else 0)
    parts = mesh.shape["data"]
    if not heads or heads % parts:
        return None
    length = shape.seq_len

    def split(func, args):
        a, b = args[0], args[1]
        return parts if (func._overloadpacket is torch.ops.aten.bmm
                         and a.shape[-1] == length
                         and b.shape[-2] == length) else 1
    return split


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             overrides: dict | None = None, tag: str = "") -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = get_shape(shape_name)
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": SKIP_REASON}

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.chips
    mode = "train" if shape.kind == "train" else "serve"
    rules = make_rules(cfg, multi_pod=multi_pod, mode=mode,
                       global_batch=shape.global_batch)
    model = build_model(cfg, device="meta")
    fn, params, persistent = _step(cfg, shape, model)
    layouts = [(tree, tree_shardings(specs, mesh, rules, tree))
               for tree, specs in persistent]
    persistent_bytes = sum(sharded_bytes(tree, sh, mesh)
                           for tree, sh in layouts)

    shards = [(leaf, math.prod(shard) / max(leaf.numel(), 1))
              for tree, sh in layouts
              for leaf, shard in leaf_shards(tree, sh, mesh)]
    hh = counting.count(fn, chips=chips,
                        replicas=work_replicas(rules, mesh, shape),
                        shards=shards,
                        split=value_split(cfg, shape, rules, mesh),
                        matcher=counting.kernel_matcher(cfg, shape))
    param_specs = model.param_specs()
    coll_by_op = collectives.step_collectives(
        cfg, shape, rules, mesh, param_specs,
        tree_shardings(param_specs, mesh, rules, params), params)
    per_dev_coll = float(sum(v["wire_bytes"] for v in coll_by_op.values()))

    terms = roofline_terms(
        per_device_flops=hh["flops"], per_device_bytes=hh["bytes"],
        per_device_coll_bytes=per_dev_coll, chips=chips, cfg=cfg,
        shape=shape)
    print("count: flops=%.4g bytes=%.4g coll=%.4g" %
          (hh["flops"], hh["bytes"], per_dev_coll))

    kadj = None
    if shape.kind != "decode":
        # score tiles: causal blocks skipped, so their dots are halved;
        # SSD chunk dots are dense (the reference's factor 0.0)
        dots = hh["tile_dot_flops"] if not cfg.attention_free else 0.0
        adj_flops = hh["flops"] - 0.5 * dots
        adj_bytes = max(hh["bytes"] - hh["tile_bytes"], 0.0)
        kadj = roofline_terms(
            per_device_flops=adj_flops, per_device_bytes=adj_bytes,
            per_device_coll_bytes=per_dev_coll, chips=chips, cfg=cfg,
            shape=shape)
        kadj["removed_tile_bytes"] = hh["tile_bytes"]
        kadj["halved_score_dot_flops"] = dots
        print("kernel-adjusted: flops=%.4g bytes=%.4g -> bound=%.4gs" %
              (adj_flops, adj_bytes, kadj["bound_s"]))

    rec = {
        "arch": arch, "shape": shape_name, "tag": tag,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips, "kind": shape.kind,
        "compile_s": None, "count_s": hh["count_s"],
        "memory_analysis": {"error": _NO_PROGRAM},
        "cost_analysis": {"error": _NO_PROGRAM},
        "persistent_bytes_per_device": persistent_bytes,
        "collectives": coll_by_op, "roofline": terms,
        "roofline_kernel_adjusted": kadj,
        "scheme": rules.get("tp") and "tp" or "sp",
        "ok": True,
    }
    out_path = _cell_out(Path(out_dir), arch, shape_name, multi_pod, tag)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: "
          f"count {hh['count_s']:.1f}s, dominant={terms['dominant']}, "
          f"bound={terms['bound_s']:.4g}s")
    return rec


def sweep(out_dir: Path, multi_pod_too: bool = True, force: bool = False):
    """Every arch x shape x mesh cell, one child process
    (``python -m repro_torch.launch.dryrun``) a cell, serially, as the
    reference's sweep.  A cell whose record reads ``ok`` or ``skipped``
    counts as done and is not redone unless ``force``; an inapplicable
    shape gets the sweep's own skip record; a child that exits non-zero
    leaves a failure record with the tails of its output.  The configs
    are read from ``repro_torch.configs`` at the call, so a caller can
    cut the list in this process."""
    from repro_torch.configs import (SHAPES, get_config, list_archs,
                                     shape_applicable)
    cells = []
    for arch in list_archs():
        for shape in SHAPES:
            for mp in ([False, True] if multi_pod_too else [False]):
                cells.append((arch, shape, mp))
    done = failed = skipped = 0
    for arch, shape, mp in cells:
        out = _cell_out(out_dir, arch, shape, mp)
        mesh = "2x16x16" if mp else "16x16"
        if out.exists() and not force:
            prev = json.loads(out.read_text())
            if prev.get("ok") or prev.get("skipped"):
                done += 1
                continue
        if not shape_applicable(get_config(arch), SHAPES[shape]):
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(
                {"arch": arch, "shape": shape, "skipped": True,
                 "mesh": mesh, "reason": SWEEP_SKIP_REASON}))
            skipped += 1
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(out_dir)]
        if mp:
            cmd.append("--multi-pod")
        print(f"[sweep] {arch} x {shape} x {mesh}", flush=True)
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=7200)
        if r.returncode != 0:
            failed += 1
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(
                {"arch": arch, "shape": shape, "ok": False, "mesh": mesh,
                 "error": r.stdout[-2000:] + r.stderr[-4000:]}))
            print(f"[sweep] FAILED {arch} x {shape}:\n{r.stderr[-1500:]}",
                  flush=True)
        else:
            done += 1
    print(f"[sweep] done={done} failed={failed} skipped={skipped}")


def parse_overrides(pairs) -> dict:
    """``key=value`` pairs, each value an int, else a float, else the
    string (the reference's ``--set`` parsing)."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="the full sweep, one child process a cell")
    ap.add_argument("--force", action="store_true",
                    help="redo cells --all finds recorded")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="", help="suffix for the output record")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (perf hillclimb)")
    args = ap.parse_args(argv)
    overrides = parse_overrides(getattr(args, "set"))
    if args.all:
        sweep(Path(args.out), force=args.force)
        return
    try:
        run_cell(args.arch, args.shape, args.multi_pod, Path(args.out),
                 overrides=overrides or None, tag=args.tag)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
