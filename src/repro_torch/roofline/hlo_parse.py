"""Optimized-HLO text analyzer with while-loop trip-count multiplication.

``compiled.cost_analysis()`` counts each ``while`` (scan) body ONCE — for a
scan-over-layers model that undercounts flops/bytes/collectives by ~L×.
This module re-derives the three roofline inputs from the partitioned HLO
text itself:

  * flops            — 2 · |result| · |contraction| per dot (+conv), × trips
  * bytes accessed   — per top-level instruction: operands + result
                       (dynamic-slice/gather count slice bytes, not the full
                       operand), × trips.  Post-fusion instruction boundaries
                       approximate materialized HBM buffers.
  * collectives      — ring-algorithm wire bytes per op, × trips

The same per-instruction walk feeds the simulator's workload trace
(core/apps/transformer.py): this is SimBLAS's "operation count" input,
extracted from the compiled artifact instead of the BLAS call site.

Port of ``repro.roofline.hlo_parse``, function for function: pure Python
on HLO text, no tensor.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

from .analysis import ring_wire_bytes

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "f8e4m3": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
    "token": 0, "opaque": 0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
# type group is lazy: tuple types may contain `/*index=N*/` comments (which
# include '='), so we find the earliest `<type> <opcode>(` split instead.
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s+([\w\-]+)\((.*)$")
# computation headers start at column 0: `%name (args) -> type {` / `ENTRY %...`
_COMP_START_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*->.*\{\s*$")
_TRIP_RE = re.compile(r'known_trip_count[\\\'":{ ]+n[\\\'": ]+(\d+)')
_CONST_RE = re.compile(r"constant\((\d+)\)")
_CALLED_RE = re.compile(r"(?:condition|body|to_apply|calls|branch_computations)="
                        r"\{?%?([\w.\-]+(?:,\s*%?[\w.\-]+)*)\}?")


def _shape_elems(dims: str) -> int:
    n = 1
    if dims.strip():
        for d in dims.split(","):
            n *= int(d)
    return n


def _type_bytes(type_str: str) -> int:
    """bytes of a result type string: 'bf16[4,8]{1,0}' or '(f32[2], s32[])'."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        total += _shape_elems(m.group(2)) * _DTYPE_BYTES.get(m.group(1), 4)
    return total


@dataclasses.dataclass
class Instr:
    name: str
    type_str: str
    opcode: str
    rest: str           # operand list + attrs (raw tail of the line)
    operands: List[str]


@dataclasses.dataclass
class Computation:
    name: str
    instrs: List[Instr]
    symbols: Dict[str, str]  # instr name -> type string


def _split_operands(rest: str) -> Tuple[List[str], str]:
    """Split the '(...), attrs' tail into operand names and the attr tail."""
    depth = 0
    end = len(rest)
    for i, ch in enumerate(rest):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                end = i
                break
    inner = rest[:end]
    tail = rest[end + 1:]
    ops = []
    for tok in re.split(r",\s*(?![^(]*\))", inner):
        tok = tok.strip()
        m = re.match(r"^%?([\w.\-]+)$", tok)
        if m:
            ops.append(m.group(1))
        else:
            # typed operand like 'bf16[2,3]{1,0} %name'
            m2 = re.search(r"%([\w.\-]+)\s*$", tok)
            if m2:
                ops.append(m2.group(1))
    return ops, tail


def parse_hlo_module(text: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for line in text.splitlines():
        stripped = line.rstrip()
        if cur is None:
            if stripped[:1].isspace() or not stripped:
                continue
            m = _COMP_START_RE.match(stripped)
            if m and stripped.endswith("{"):
                cur = Computation(m.group(1), [], {})
            continue
        if stripped.strip() == "}":
            comps[cur.name] = cur
            cur = None
            continue
        mi = _INSTR_RE.match(stripped)
        if not mi:
            continue
        name, type_str, opcode, rest = mi.groups()
        ops, _ = _split_operands(rest)
        ins = Instr(name, type_str, opcode, rest, ops)
        cur.instrs.append(ins)
        cur.symbols[name] = type_str
    return comps


def _dot_flops(ins: Instr, symbols: Dict[str, str]) -> float:
    out_elems = sum(_shape_elems(m.group(2))
                    for m in _SHAPE_RE.finditer(ins.type_str))
    mC = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", ins.rest)
    if not mC or not ins.operands:
        return 2.0 * out_elems  # degenerate
    lhs_type = symbols.get(ins.operands[0], "")
    ms = _SHAPE_RE.search(lhs_type)
    if not ms:
        return 2.0 * out_elems
    dims = [int(d) for d in ms.group(2).split(",")] if ms.group(2) else []
    k = 1
    for ci in mC.group(1).split(","):
        if ci != "" and int(ci) < len(dims):
            k *= dims[int(ci)]
    return 2.0 * out_elems * k


def _conv_flops(ins: Instr, symbols: Dict[str, str]) -> float:
    # rough: 2 * out_elems * (kernel_elems / out_channels)
    out_elems = sum(_shape_elems(m.group(2))
                    for m in _SHAPE_RE.finditer(ins.type_str))
    if len(ins.operands) >= 2:
        ktype = symbols.get(ins.operands[1], "")
        ms = _SHAPE_RE.search(ktype)
        if ms and ms.group(2):
            kd = [int(d) for d in ms.group(2).split(",")]
            return 2.0 * out_elems * max(1, math.prod(kd[:-1]))
    return 2.0 * out_elems


_GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _group_size(rest: str) -> int:
    gm = _GROUPS_RE.search(rest)
    if gm:
        return len(gm.group(1).split(","))
    gi = _GROUPS_IOTA_RE.search(rest)
    if gi:
        return int(gi.group(2))
    return 1


def _collective_wire(opcode: str, ins: Instr, symbols: Dict[str, str]) -> Tuple[float, int]:
    rbytes = _type_bytes(ins.type_str)
    if opcode.endswith("-start"):
        opcode = opcode[:-6]
    gs = _group_size(ins.rest)
    return ring_wire_bytes(opcode, rbytes, gs), gs


_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_SLICE_LIKE = ("dynamic-slice", "gather")
_NO_BYTES = ("parameter", "constant", "tuple", "get-tuple-element", "bitcast",
             "after-all", "iota", "partition-id", "replica-id")


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_wire: float = 0.0
    coll_by_op: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    instr_count: float = 0.0

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.coll_wire += other.coll_wire * mult
        self.instr_count += other.instr_count * mult
        for k, v in other.coll_by_op.items():
            agg = self.coll_by_op.setdefault(k, {"count": 0.0,
                                                 "wire_bytes": 0.0})
            agg["count"] += v["count"] * mult
            agg["wire_bytes"] += v["wire_bytes"] * mult


def _trip_count(cond: Optional[Computation], ins: Instr) -> int:
    m = _TRIP_RE.search(ins.rest)
    if m:
        return int(m.group(1))
    if cond is not None:
        consts = []
        for i2 in cond.instrs:
            if i2.opcode == "constant":
                mc = re.match(r"\s*(\d+)\s*\)", i2.rest)
                if mc:
                    consts.append(int(mc.group(1)))
            consts.extend(int(c) for c in _CONST_RE.findall(i2.rest))
        if consts:
            return max(consts)
    return 1


class HloAnalyzer:
    def __init__(self, text: str):
        self.comps = parse_hlo_module(text)
        self._memo: Dict[str, Cost] = {}
        entry = None
        for name in self.comps:
            if name.startswith("main") or ".main" in name:
                entry = name
        if entry is None and self.comps:
            # ENTRY is the last computation in XLA dumps
            entry = list(self.comps)[-1]
        self.entry = entry

    def cost(self, comp_name: Optional[str] = None) -> Cost:
        comp_name = comp_name or self.entry
        if comp_name in self._memo:
            return self._memo[comp_name]
        comp = self.comps.get(comp_name)
        total = Cost()
        if comp is None:
            return total
        self._memo[comp_name] = total  # guard (no real cycles in HLO)
        for ins in comp.instrs:
            op = ins.opcode
            if op == "while":
                body = cond = None
                mb = re.search(r"body=%?([\w.\-]+)", ins.rest)
                mc = re.search(r"condition=%?([\w.\-]+)", ins.rest)
                if mb:
                    body = mb.group(1)
                if mc:
                    cond = self.comps.get(mc.group(1))
                trips = _trip_count(cond, ins)
                if body:
                    total.add(self.cost(body), mult=trips)
                continue
            if op in ("call", "async-start"):
                mt = re.search(r"to_apply=%?([\w.\-]+)", ins.rest)
                if mt:
                    total.add(self.cost(mt.group(1)))
                continue
            if op == "conditional":
                mt = re.search(r"branch_computations=\{([^}]*)\}", ins.rest)
                if mt:
                    branches = [b.strip().lstrip("%")
                                for b in mt.group(1).split(",")]
                    costs = [self.cost(b) for b in branches]
                    if costs:
                        worst = max(costs, key=lambda c: c.flops + c.bytes)
                        total.add(worst)
                continue
            if op == "fusion":
                mt = re.search(r"calls=%?([\w.\-]+)", ins.rest)
                inner = self.cost(mt.group(1)) if mt else Cost()
                # fused dots still compute; bytes at the fusion boundary
                total.flops += inner.flops
                total.bytes += self._fusion_bytes(ins, comp.symbols,
                                                  mt.group(1) if mt else None)
                total.instr_count += 1
                continue
            total.instr_count += 1
            if op in ("dot",):
                total.flops += _dot_flops(ins, comp.symbols)
                total.bytes += self._io_bytes(ins, comp.symbols)
            elif op == "convolution":
                total.flops += _conv_flops(ins, comp.symbols)
                total.bytes += self._io_bytes(ins, comp.symbols)
            elif any(op.startswith(c) for c in _COLLECTIVES):
                wire, gs = _collective_wire(op, ins, comp.symbols)
                total.coll_wire += wire
                key = op[:-6] if op.endswith("-start") else op
                agg = total.coll_by_op.setdefault(
                    key, {"count": 0.0, "wire_bytes": 0.0})
                agg["count"] += 1
                agg["wire_bytes"] += wire
                total.bytes += self._io_bytes(ins, comp.symbols)
            elif op in _NO_BYTES or op.endswith("-done"):
                pass
            else:
                total.bytes += self._io_bytes(ins, comp.symbols)
        return total

    def _fusion_bytes(self, ins: Instr, symbols: Dict[str, str],
                      called: Optional[str]) -> float:
        """Fusion boundary bytes, aware of in-place dynamic-update-slice:
        a loop-carried stash updated through a DUS fusion costs 2x the
        update slice, not the whole buffer (XLA aliases it in place)."""
        comp = self.comps.get(called) if called else None
        if comp is None:
            return self._io_bytes(ins, symbols)
        dus = [i for i in comp.instrs if i.opcode == "dynamic-update-slice"]
        dsl = [i for i in comp.instrs
               if i.opcode in ("dynamic-slice", "gather")]
        if not dus and not dsl:
            return self._io_bytes(ins, symbols)
        defs = {i.name: i for i in comp.instrs}

        def trace_param(name):
            seen = 0
            while name in defs and seen < 20:
                d = defs[name]
                if d.opcode == "parameter":
                    m = re.match(r"\s*(\d+)\s*\)", d.rest)
                    return int(m.group(1)) if m else None
                if d.opcode in ("convert", "bitcast", "copy", "reshape"):
                    name = d.operands[0] if d.operands else None
                    seen += 1
                    continue
                return None
            return None

        skip_params = set()
        slice_bytes = 0.0
        dus_names = set()
        for d in dus:
            dus_names.add(d.name)
            if len(d.operands) > 1:
                slice_bytes += 2.0 * _type_bytes(
                    comp.symbols.get(d.operands[1], ""))
            pi = trace_param(d.operands[0]) if d.operands else None
            if pi is not None:
                skip_params.add(pi)
        for d in dsl:  # reads of one slice of a big (stacked) buffer
            slice_bytes += _type_bytes(d.type_str)
            pi = trace_param(d.operands[0]) if d.operands else None
            if pi is not None:
                skip_params.add(pi)
        # root derived from a DUS (possibly via convert/bitcast/tuple)?
        root = comp.instrs[-1] if comp.instrs else None
        out_bytes = _type_bytes(ins.type_str)

        def derives_from_dus(name, depth=0):
            if name in dus_names:
                return True
            d = defs.get(name)
            if d is None or depth > 20:
                return False
            if d.opcode in ("convert", "bitcast", "copy", "reshape", "tuple"):
                return any(derives_from_dus(o, depth + 1) for o in d.operands)
            return False

        if root is not None and derives_from_dus(root.name):
            out_bytes = 0.0
        op_bytes = 0.0
        for idx, o in enumerate(ins.operands):
            if idx in skip_params:
                continue
            op_bytes += _type_bytes(symbols.get(o, ""))
        return out_bytes + op_bytes + slice_bytes

    def _io_bytes(self, ins: Instr, symbols: Dict[str, str]) -> float:
        out_b = _type_bytes(ins.type_str)
        if ins.opcode in _SLICE_LIKE:
            return 2.0 * out_b              # read slice + write result
        if ins.opcode == "dynamic-update-slice":
            upd = symbols.get(ins.operands[1], "") if len(ins.operands) > 1 \
                else ""
            return 2.0 * _type_bytes(upd)   # read update + write region
        if ins.opcode == "scatter":
            upd = symbols.get(ins.operands[-1], "") if ins.operands else ""
            return 2.0 * _type_bytes(upd) + out_b
        op_b = sum(_type_bytes(symbols.get(o, "")) for o in ins.operands)
        return out_b + op_b


def analyze(text: str) -> Dict:
    an = HloAnalyzer(text)
    c = an.cost()
    return {
        "flops": c.flops,
        "bytes": c.bytes,
        "coll_wire_bytes": c.coll_wire,
        "collectives": c.coll_by_op,
        "instr_count": c.instr_count,
    }


def score_matcher(sq: int, blk: int, min_rank: int = 3):
    """Matches attention-score-shaped results: last two dims are
    (m·sq_shard, blk) or (blk, m·sq_shard) for any seq shard (sq or
    sq/2^i) possibly merged with head dims by XLA reshapes."""
    shards = {sq // (1 << i) for i in range(6) if sq % (1 << i) == 0}

    def is_seqish(d):
        return any(d % s == 0 for s in shards if s >= blk // 2 and s > 1)

    def match(dims):
        if len(dims) < min_rank:
            return False
        a, b = dims[-2], dims[-1]
        return ((b == blk and is_seqish(a))
                or (a == blk and is_seqish(b)))
    return match


def chunk_matcher(q: int, min_rank: int = 3):
    """Matches SSD (Q, Q) intra-chunk matrices in any layout: some
    adjacent dim pair is (Q, Q) or (Q, m·Q) — covers (..., Q, Q, H),
    (H, Q, Q) and head-merged (Q, H·Q) variants."""
    def match(dims):
        if len(dims) < min_rank:
            return False
        for a, b in zip(dims[:-1], dims[1:]):
            if (a == q and b % q == 0) or (b == q and a % q == 0):
                return True
        return False
    return match


def pattern_traffic(text: str, match_fn):
    """Measured bytes + dot-flops of instructions whose result shape
    satisfies ``match_fn(dims)``, with while-loop multipliers.

    Used by the kernel-adjusted roofline (§Perf): a Pallas flash/SSD
    kernel keeps these tiles in VMEM, so their HBM traffic is removed and
    causally-skippable score flops are halved.  The numbers subtracted are
    *measured from the same compiled HLO*, not estimated.
    """
    an = HloAnalyzer(text)
    mult = _loop_multipliers(an)
    bytes_total = 0.0
    dot_flops = 0.0
    for cname, m in mult.items():
        comp = an.comps.get(cname)
        if comp is None:
            continue
        for ins in comp.instrs:
            if ins.opcode in _NO_BYTES or ins.opcode == "while":
                continue
            ms = list(_SHAPE_RE.finditer(ins.type_str))
            if not ms:
                continue
            dims_s = ms[0].group(2)
            dims = [int(d) for d in dims_s.split(",")] if dims_s else []
            if not match_fn(dims):
                continue
            if ins.opcode == "fusion":
                mf = re.search(r"calls=%?([\w.\-]+)", ins.rest)
                b = an._fusion_bytes(ins, comp.symbols,
                                     mf.group(1) if mf else None)
            else:
                b = an._io_bytes(ins, comp.symbols)
            bytes_total += b * m
            if ins.opcode == "dot":
                dot_flops += _dot_flops(ins, comp.symbols) * m
    return {"bytes": bytes_total, "dot_flops": dot_flops}


def _loop_multipliers(an: "HloAnalyzer"):
    mult = {an.entry: 1.0}
    order = [an.entry]
    i = 0
    while i < len(order):
        cname = order[i]
        i += 1
        comp = an.comps.get(cname)
        if comp is None:
            continue
        m = mult[cname]
        for ins in comp.instrs:
            if ins.opcode != "while":
                continue
            mm = re.search(r"body=%?([\w.\-]+)", ins.rest)
            if not mm:
                continue
            mc = re.search(r"condition=%?([\w.\-]+)", ins.rest)
            cond = an.comps.get(mc.group(1)) if mc else None
            trips = _trip_count(cond, ins)
            cm = m * trips
            if mult.get(mm.group(1), 0) < cm:
                mult[mm.group(1)] = cm
                order.append(mm.group(1))
    return mult


def top_instructions(text: str, n: int = 25, key: str = "bytes"):
    """Profiler view: instructions ranked by bytes (or flops) including the
    loop multiplier of every enclosing while.  This is the dry-run analogue
    of a wall-clock profile, read from the lowered program."""
    an = HloAnalyzer(text)
    mult = _loop_multipliers(an)
    rows = []
    for cname, m in mult.items():
        comp = an.comps.get(cname)
        if comp is None:
            continue
        for ins in comp.instrs:
            if ins.opcode in _NO_BYTES or ins.opcode == "while":
                continue
            if ins.opcode == "fusion":
                mf = re.search(r"calls=%?([\w.\-]+)", ins.rest)
                b = an._fusion_bytes(ins, comp.symbols,
                                     mf.group(1) if mf else None)
            else:
                b = an._io_bytes(ins, comp.symbols)
            f = _dot_flops(ins, comp.symbols) if ins.opcode == "dot" else 0.0
            rows.append({"comp": cname, "instr": ins.name, "op": ins.opcode,
                         "mult": m, "bytes": b * m, "flops": f * m,
                         "type": ins.type_str[:80]})
    rows.sort(key=lambda r: -r[key])
    return rows[:n]
