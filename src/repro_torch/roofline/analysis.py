"""Three-term roofline analysis from a compiled dry-run artifact.

    compute term    = HLO_FLOPs   / (chips x peak_FLOP/s)
    memory term     = HLO_bytes   / (chips x HBM_bw)
    collective term = coll_bytes  / (chips x link_bw)

``cost_analysis()`` on the partitioned module reports *per-device* flops /
bytes; we multiply back to whole-program numbers so the formulas above can
be applied uniformly.  collective_bytes is parsed from the (partitioned)
HLO text: for each all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute op we derive ring-algorithm wire bytes from the result
shape and the replica-group size.

``Hardware``'s defaults describe the *modelled target*: one chip of the
TPU pod that the dry-run meshes describe.  They are inputs of a
prediction, as a ``Platform`` spec is, and not figures of the card the
port runs on.

Port of ``repro.roofline.analysis``, function for function: pure Python
on HLO text and config fields, no tensor.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Hardware:
    peak_flops: float = 197e12       # bf16 FLOP/s per chip
    hbm_bw: float = 819e9            # B/s per chip
    link_bw: float = 50e9            # B/s per ICI link (one-link bound)
    ici_links: int = 4               # 2-D torus: +-x, +-y (alt. bound)
    dcn_bw: float = 25e9             # B/s per chip across pods (pod axis)
    hbm_per_chip: float = 16e9       # bytes
    # power model — the paper's stated future work (§VI), implemented:
    # P(t) = idle + dynamic * utilization; energy integrates over the step.
    idle_watts: float = 70.0         # per chip, host share included
    dynamic_watts: float = 130.0     # at full MXU utilization (~200 W TDP class)


HW = Hardware()

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

# e.g.  %all-gather.3 = bf16[16,2048,896]{2,1,0} all-gather(%x), ...
_COLL_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+)\[([\d,]*)\][^ ]*)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(", )

_GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims.strip():
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _tuple_bytes(inner: str) -> int:
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", inner):
        total += _shape_bytes(m.group(1), m.group(2))
    return total


def ring_wire_bytes(op: str, result_bytes: float, group_size: int) -> float:
    """Ring-algorithm bytes one device sends for a collective ``op`` whose
    result is ``result_bytes`` (an all-gather's gathered array, a
    reduce-scatter's scattered shard) over ``group_size`` devices; a
    group of one moves nothing, except a collective-permute."""
    gs = group_size
    if gs <= 1 and op != "collective-permute":
        return 0.0
    if op == "all-reduce":
        return 2.0 * (gs - 1) / gs * result_bytes
    if op == "all-gather":
        return (gs - 1) / gs * result_bytes          # result = gathered
    if op == "reduce-scatter":
        return float((gs - 1) * result_bytes)        # result = scattered shard
    if op == "all-to-all":
        return (gs - 1) / gs * result_bytes
    return float(result_bytes)                       # collective-permute


def parse_hlo_collectives(hlo_text: str) -> List[Dict]:
    """Returns one record per collective: op, result_bytes, group_size,
    wire_bytes (ring-algorithm bytes per participating device)."""
    out = []
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        tuple_inner, dtype, dims, op = m.groups()
        rbytes = _tuple_bytes(tuple_inner) if tuple_inner \
            else _shape_bytes(dtype, dims)
        gs = 1
        gm = _GROUPS_RE.search(line)
        if gm:
            gs = len(gm.group(1).split(","))
        else:
            gi = _GROUPS_IOTA_RE.search(line)
            if gi:
                gs = int(gi.group(2))  # [num_groups, group_size]
        wire = ring_wire_bytes(op, rbytes, gs)
        out.append({"op": op, "result_bytes": rbytes, "group_size": gs,
                    "wire_bytes": wire})
    return out


def collective_bytes(hlo_text: str) -> float:
    """Per-device collective wire bytes for the whole program."""
    return float(sum(r["wire_bytes"] for r in parse_hlo_collectives(hlo_text)))


def model_flops(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode counts one token/seq."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.tokens
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch  # decode: one new token per sequence


def roofline_terms(*, per_device_flops: float, per_device_bytes: float,
                   per_device_coll_bytes: float, chips: int,
                   cfg=None, shape=None, hw: Hardware = HW) -> Dict:
    compute_t = per_device_flops / hw.peak_flops
    memory_t = per_device_bytes / hw.hbm_bw
    coll_t = per_device_coll_bytes / hw.link_bw
    coll_t_multilink = per_device_coll_bytes / (hw.link_bw * hw.ici_links)
    dominant = max((("compute", compute_t), ("memory", memory_t),
                    ("collective", coll_t)), key=lambda kv: kv[1])[0]
    bound = max(compute_t, memory_t, coll_t)
    out = {
        "compute_s": compute_t, "memory_s": memory_t, "collective_s": coll_t,
        "collective_multilink_s": coll_t_multilink,
        "dominant": dominant, "bound_s": bound,
        "chips": chips,
        "hlo_flops_total": per_device_flops * chips,
        "hlo_bytes_total": per_device_bytes * chips,
        "coll_bytes_per_device": per_device_coll_bytes,
    }
    # energy model (paper §VI future work): utilization = compute term /
    # step bound; idle power burns for the whole step on every chip.
    util = compute_t / max(bound, 1e-12)
    energy_j = chips * bound * (hw.idle_watts + hw.dynamic_watts * util)
    out["energy_j"] = energy_j
    out["avg_watts_per_chip"] = hw.idle_watts + hw.dynamic_watts * util
    if cfg is not None and shape is not None:
        mf = model_flops(cfg, shape)
        out["model_flops"] = mf
        out["useful_flops_ratio"] = mf / max(per_device_flops * chips, 1.0)
        # roofline fraction: useful model flops per second at the bound vs peak
        out["mfu_at_bound"] = (mf / max(bound, 1e-12)) / (chips * hw.peak_flops)
        out["joules_per_token"] = energy_j / max(
            shape.tokens if shape.kind != "decode" else shape.global_batch, 1)
    return out
