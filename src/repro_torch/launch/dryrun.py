"""Dry-run: describe one (arch x shape x mesh) cell as the reference's
dry-run record, without a mesh, a process group or a card.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k \\
        --multi-pod
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k \\
        --set force_scheme=dp --tag dp

Port of ``repro.launch.dryrun``'s ``run_cell`` and its CLI.  The
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

``--all`` (the reference's sweep, one child process a cell) is not
ported yet: it exits 2, and so does ``--force``, which in the reference
only makes the sweep redo cells that have a record.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback
from pathlib import Path

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
from repro_torch.sharding.specs import (make_rules, sharded_bytes,
                                        tree_shardings)
from repro_torch.train.step import make_train_step, state_specs

_NO_PROGRAM = ("no XLA program: repro_torch counts its own step on meta "
               "tensors (repro_torch.roofline.count)")
SKIP_REASON = "long_500k requires sub-quadratic attention (see DESIGN.md §5)"


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
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             enc_len=cfg.encoder_seq or 0)

    def decode():
        copy = map_with_keys(lambda _, v: v.clone()
                             if isinstance(v, torch.Tensor) else v, cache)
        return model.decode(params, copy, batch["tokens"])
    return decode, params, persistent


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
    persistent_bytes = sum(
        sharded_bytes(tree, tree_shardings(specs, mesh, rules, tree), mesh)
        for tree, specs in persistent)

    hh = counting.count(fn, chips=chips,
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
                    help="the full sweep (not yet ported)")
    ap.add_argument("--force", action="store_true",
                    help="redo recorded cells in --all (not yet ported)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="", help="suffix for the output record")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (perf hillclimb)")
    args = ap.parse_args(argv)
    if args.all or args.force:
        print(f"[dryrun] {'--all' if args.all else '--force'}: the sweep "
              "is not yet ported; run one cell with --arch and --shape",
              file=sys.stderr)
        raise SystemExit(2)
    overrides = parse_overrides(getattr(args, "set"))
    try:
        run_cell(args.arch, args.shape, args.multi_pod, Path(args.out),
                 overrides=overrides or None, tag=args.tag)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
