"""HLO frontend — eDAG + roofline/collective analysis of compiled XLA modules.

The "runtime instruction trace" of a compiled, sharded step is its
post-SPMD HLO module; the "memory accesses behind a high-latency fabric"
are the collectives on each mesh axis.  We parse the module's text into
per-computation op graphs, infer while-loop trip counts (a scan over
layers), classify collectives per mesh axis from their replica groups, and
compute the paper's W / D / lambda per axis plus the three roofline terms.

Framework-free text parsing: the port keeps its own copy of the reference
package's reader, so that the two give the same dicts on the same text.
Every per-axis depth is one ``EDag.mem_layers`` pass of the port's engine,
so on the card it runs the level kernel.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import EDag

_ITEMSIZE = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "fp8": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1, "f8e4m3": 1, "f8e5m2fnuz": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

_SHAPE_RE = re.compile(r"([a-z]\w*)\[([\d,]*)\]")

COLLECTIVE_OPS = {
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast",
    "all-reduce-start", "all-gather-start", "collective-permute-start",
    "ragged-all-to-all",
}
_DONE_OPS = {"all-reduce-done", "all-gather-done", "collective-permute-done",
             "async-done"}


def shape_bytes(type_str: str) -> int:
    """Total bytes of an HLO type string (handles tuples)."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _ITEMSIZE:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _ITEMSIZE[dt]
    return total


@dataclass
class HloOp:
    name: str
    opcode: str
    type_str: str
    operands: List[str]
    attrs: str
    line: str

    @property
    def result_bytes(self) -> int:
        return shape_bytes(self.type_str)


@dataclass
class HloComputation:
    name: str
    ops: List[HloOp] = field(default_factory=list)
    by_name: Dict[str, HloOp] = field(default_factory=dict)
    is_entry: bool = False


_COMP_HDR = re.compile(r"^\s*(ENTRY\s+)?%?([\w.\-]+)\s*\(")
_OP_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")


def _split_type_op(rhs: str) -> Tuple[str, str, str, str]:
    """Split '<type> <opcode>(<operands>), attrs' -> (type, opcode, operands, attrs)."""
    rhs = rhs.strip()
    if rhs.startswith("("):                     # tuple type
        depth = 0
        for i, ch in enumerate(rhs):
            depth += ch == "("
            depth -= ch == ")"
            if depth == 0:
                type_str, rest = rhs[: i + 1], rhs[i + 1:]
                break
        else:
            return rhs, "", "", ""
    else:
        sp = rhs.find(" ")
        if sp < 0:
            return rhs, "", "", ""
        type_str, rest = rhs[:sp], rhs[sp:]
    rest = rest.strip()
    par = rest.find("(")
    if par < 0:
        return type_str, rest, "", ""
    opcode = rest[:par].strip()
    depth = 0
    for i in range(par, len(rest)):
        depth += rest[i] == "("
        depth -= rest[i] == ")"
        if depth == 0:
            return type_str, opcode, rest[par + 1: i], rest[i + 1:]
    return type_str, opcode, rest[par + 1:], ""


_OPERAND_RE = re.compile(r"%?([\w.\-]+)")


def parse_hlo(text: str) -> Dict[str, HloComputation]:
    """Parse an HLO module's text into computations with op lists."""
    comps: Dict[str, HloComputation] = {}
    cur: Optional[HloComputation] = None
    for raw in text.splitlines():
        line = raw.rstrip()
        if not line or line.lstrip().startswith("//"):
            continue
        if line.endswith("{") and "->" in line and "=" not in line.split("(")[0]:
            m = _COMP_HDR.match(line)
            if m:
                cur = HloComputation(name=m.group(2), is_entry=bool(m.group(1)))
                comps[cur.name] = cur
                continue
        if line.strip() == "}":
            continue
        if cur is None:
            continue
        m = _OP_RE.match(line)
        if not m:
            continue
        name, rhs = m.group(1), m.group(2)
        type_str, opcode, operand_str, attrs = _split_type_op(rhs)
        # operands are top-level %refs in the operand string; strip nested
        # type annotations like 'f32[4]{0} %x' by keeping %-prefixed tokens,
        # else bare tokens that aren't literals.
        operands = []
        depth = 0
        token = []
        parts = []
        for ch in operand_str:
            depth += ch in "({["
            depth -= ch in ")}]"
            if ch == "," and depth == 0:
                parts.append("".join(token))
                token = []
            else:
                token.append(ch)
        if token:
            parts.append("".join(token))
        for p in parts:
            p = p.strip()
            refs = re.findall(r"%([\w.\-]+)", p)
            if refs:
                operands.append(refs[-1])
            elif re.fullmatch(r"[\w.\-]+", p) and not re.fullmatch(r"-?[\d.e+\-]+", p):
                operands.append(p)
        op = HloOp(name=name, opcode=opcode, type_str=type_str,
                   operands=operands, attrs=attrs, line=line)
        cur.ops.append(op)
        cur.by_name[name] = op
    return comps


# ---------------------------------------------------------------- multipliers

_TRIP_CONST_RE = re.compile(r"constant\((\d+)\)")


def _infer_trip_count(cond: HloComputation) -> int:
    """lax.scan lowers to a while whose cond compares the counter to a
    constant trip count; take the largest integer constant in the cond."""
    best = 1
    for op in cond.ops:
        if op.opcode == "constant":
            m = _TRIP_CONST_RE.search(op.line)
            if m:
                best = max(best, int(m.group(1)))
    return best


def computation_multipliers(comps: Dict[str, HloComputation]) -> Dict[str, float]:
    """multiplier[comp] = expected number of executions per step (while trip
    counts composed along the call chain)."""
    entry = next((c for c in comps.values() if c.is_entry), None)
    mult: Dict[str, float] = {c: 0.0 for c in comps}
    if entry is None:
        return {c: 1.0 for c in comps}
    mult[entry.name] = 1.0
    # propagate in a few rounds (call graph is shallow)
    for _ in range(8):
        changed = False
        for comp in comps.values():
            m0 = mult.get(comp.name, 0.0)
            if m0 <= 0:
                continue
            for op in comp.ops:
                if op.opcode == "while":
                    body = re.search(r"body=%?([\w.\-]+)", op.attrs)
                    cond = re.search(r"condition=%?([\w.\-]+)", op.attrs)
                    trips = 1
                    if cond and cond.group(1) in comps:
                        trips = _infer_trip_count(comps[cond.group(1)])
                    for ref in (body, cond):
                        if ref and ref.group(1) in comps:
                            new = m0 * trips
                            if new > mult.get(ref.group(1), 0.0):
                                mult[ref.group(1)] = new
                                changed = True
                elif op.opcode == "conditional":
                    for ref in re.findall(r"computation=%?([\w.\-]+)", op.attrs) + \
                            re.findall(r"branch_computations=\{([^}]*)\}", op.attrs):
                        for nm in re.findall(r"%?([\w.\-]+)", ref):
                            if nm in comps and m0 > mult.get(nm, 0.0):
                                mult[nm] = m0
                                changed = True
        if not changed:
            break
    for c in comps:
        if mult.get(c, 0.0) <= 0:
            mult[c] = 0.0   # fused/reducer computations handled via their callers
    return mult


# ----------------------------------------------------------- replica groups

def _first_group(attrs: str) -> Optional[List[int]]:
    m = re.search(r"replica_groups=\{\{([\d,]+)\}", attrs)
    if m:
        return [int(x) for x in m.group(1).split(",")]
    m = re.search(r"source_target_pairs=\{\{(\d+),(\d+)\}", attrs)
    if m:                                   # collective-permute
        a, b = int(m.group(1)), int(m.group(2))
        return sorted((a, b)) if a != b else None
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?",
                  attrs)
    if m:
        g, s = int(m.group(1)), int(m.group(2))
        dims = [int(x) for x in m.group(3).split(",")]
        arr = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(4):
            arr = arr.transpose([int(x) for x in m.group(4).split(",")])
        arr = arr.reshape(g, s)
        return [int(x) for x in arr[0]]
    return None


def axis_signature_table(mesh_axis_sizes: Sequence[Tuple[str, int]]):
    """(group_size, stride) -> human axis label, for all contiguous axis runs
    of a row-major device mesh.  E.g. [('pod',2),('data',16),('model',16)]."""
    names = [n for n, _ in mesh_axis_sizes]
    sizes = [s for _, s in mesh_axis_sizes]
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    table = {}
    for i in range(len(sizes)):
        for j in range(i, len(sizes)):
            size = int(np.prod(sizes[i:j + 1]))
            stride = strides[j]
            label = "+".join(names[i:j + 1])
            table[(size, stride)] = label
    return table


def classify_axis(attrs: str, table) -> str:
    grp = _first_group(attrs)
    if not grp:
        return "unknown"
    size = len(grp)
    if size <= 1:
        return "self"
    stride = grp[1] - grp[0]
    exact = table.get((size, stride))
    if exact:
        return exact
    # sub-axis collective (e.g. half the model ring): classify by the
    # smallest axis run that contains the group's device-id span — what
    # matters for lambda is which fabric (pod DCI vs intra-pod ICI) it rides.
    span = grp[-1] - grp[0] + 1
    best = None
    for (sz, st), label in table.items():
        cover = sz * st               # id-span covered by that axis run
        if st <= stride and span <= cover:
            if best is None or cover < best[0]:
                best = (cover, label)
    if best:
        return best[1] + "(sub)"
    return f"mixed(size={size},stride={stride})"


# ------------------------------------------------------------------ analysis

@dataclass
class CollectiveStats:
    count: float = 0.0
    bytes: float = 0.0
    depth: float = 0.0     # paper's memory depth D, per axis

    def as_dict(self):
        return dict(count=self.count, bytes=self.bytes, depth=self.depth)


def _comp_edag(comp: HloComputation, flags: Dict[str, bool]) -> EDag:
    g = EDag()
    ids: Dict[str, int] = {}
    for op in comp.ops:
        vid = g.add_vertex(cost=1.0, is_mem=flags.get(op.name, False),
                           nbytes=float(op.result_bytes), label=op.opcode)
        ids[op.name] = vid
        for o in op.operands:
            if o in ids:
                g.add_edge(ids[o], vid)
    return g


def _operand_bytes(comp: HloComputation, op: HloOp) -> int:
    total = 0
    for o in op.operands:
        src = comp.by_name.get(o)
        if src is not None:
            total += src.result_bytes
    return total or op.result_bytes


def analyze_collectives(text: str,
                        mesh_axis_sizes: Sequence[Tuple[str, int]]) -> dict:
    """Per-mesh-axis collective W (count), bytes, and D (layer depth),
    with while bodies scaled by inferred trip counts."""
    comps = parse_hlo(text)
    mult = computation_multipliers(comps)
    table = axis_signature_table(mesh_axis_sizes)
    per_axis: Dict[str, CollectiveStats] = {}
    total = CollectiveStats()

    for comp in comps.values():
        m0 = mult.get(comp.name, 0.0)
        if m0 <= 0:
            continue
        coll_flags: Dict[str, bool] = {}
        axis_of: Dict[str, str] = {}
        for op in comp.ops:
            if op.opcode in COLLECTIVE_OPS:
                coll_flags[op.name] = True
                axis_of[op.name] = classify_axis(op.attrs, table)
        if not coll_flags:
            continue
        g = _comp_edag(comp, coll_flags)
        lay = g.mem_layers()
        # per-axis depth: layer with axis-specific memory flags
        axes = sorted(set(axis_of.values()))
        names = [op.name for op in comp.ops]
        for ax in axes:
            flags_ax = np.array([axis_of.get(nm) == ax for nm in names])
            lay_ax = g.mem_layers(is_mem=flags_ax)
            st = per_axis.setdefault(ax, CollectiveStats())
            st.depth += m0 * lay_ax.depth
        for op in comp.ops:
            if op.name in coll_flags:
                b = _operand_bytes(comp, op)
                ax = axis_of[op.name]
                st = per_axis.setdefault(ax, CollectiveStats())
                st.count += m0
                st.bytes += m0 * b
                total.count += m0
                total.bytes += m0 * b
        total.depth += m0 * lay.depth
    return dict(per_axis={k: v.as_dict() for k, v in per_axis.items()},
                total=total.as_dict(),
                multipliers={k: v for k, v in mult.items() if v > 1.0})


def hlo_flops_estimate(text: str) -> float:
    """Fallback FLOP count: 2*M*N*K per dot, scaled by trip multipliers."""
    comps = parse_hlo(text)
    mult = computation_multipliers(comps)
    # fused computations execute as often as their callers
    caller_mult: Dict[str, float] = dict(mult)
    for comp in comps.values():
        m0 = mult.get(comp.name, 0.0)
        if m0 <= 0:
            continue
        for op in comp.ops:
            for ref in re.findall(r"calls=%?([\w.\-]+)", op.attrs):
                caller_mult[ref] = max(caller_mult.get(ref, 0.0), m0)
    total = 0.0
    for comp in comps.values():
        m0 = caller_mult.get(comp.name, 0.0)
        if m0 <= 0:
            continue
        for op in comp.ops:
            if op.opcode != "dot":
                continue
            out_elems = 1
            for dt, dims in _SHAPE_RE.findall(op.type_str):
                if dims:
                    for d in dims.split(","):
                        out_elems *= int(d)
                break
            # contraction size from lhs shape and contracting dims
            k = 1
            lhs = comp.by_name.get(op.operands[0]) if op.operands else None
            mdim = re.search(r"lhs_contracting_dims=\{([\d,]+)\}", op.attrs)
            if lhs is not None and mdim:
                shp = _SHAPE_RE.search(lhs.type_str)
                if shp and shp.group(2):
                    dims = [int(d) for d in shp.group(2).split(",")]
                    for ci in mdim.group(1).split(","):
                        ci = int(ci)
                        if ci < len(dims):
                            k *= dims[ci]
            total += m0 * 2.0 * out_elems * k
    return total


def _fusion_read_bytes(comp: HloComputation, op: HloOp,
                       comps: Dict[str, HloComputation]) -> int:
    """Bytes a fusion actually reads: operands are counted at full size
    unless the fused computation only dynamic-slices them (scan weight
    slicing), in which case the slice size is charged."""
    called = None
    m = re.search(r"calls=%?([\w.\-]+)", op.attrs)
    if m:
        called = comps.get(m.group(1))
    total = 0
    for i, o in enumerate(op.operands):
        src = comp.by_name.get(o)
        full = src.result_bytes if src else 0
        if called is not None:
            # find parameter(i) in the called computation
            param = next((p for p in called.ops
                          if p.opcode == "parameter"
                          and p.line.find(f"parameter({i})") >= 0), None)
            if param is not None:
                touched = _touched_bytes(called, param, full)
                if touched is not None:
                    total += min(touched, full)
                    continue
        total += full
    return total


_PASSTHROUGH = {"convert", "copy", "bitcast", "transpose"}


def _touched_bytes(comp: HloComputation, root: HloOp, full: int):
    """Bytes of ``root`` (a fusion parameter) actually read inside the fused
    computation, following pass-through ops; None if any user reads the
    whole buffer.  dynamic-slice reads its result; an in-place
    dynamic-update-slice touches only the update region."""
    per = 0
    work = [root.name]
    seen = set()
    while work:
        nm = work.pop()
        if nm in seen:
            continue
        seen.add(nm)
        for u in comp.ops:
            if nm not in u.operands:
                continue
            if u.opcode in _PASSTHROUGH or u.opcode == "reshape":
                work.append(u.name)
            elif u.opcode == "dynamic-slice":
                per += u.result_bytes
            elif (u.opcode == "dynamic-update-slice" and
                  u.operands and u.operands[0] == nm):
                upd = (comp.by_name.get(u.operands[1])
                       if len(u.operands) > 1 else None)
                per += upd.result_bytes if upd else u.result_bytes
            elif u.opcode == "select":
                # select-form DUS (sharded/converted update): the real write
                # is the non-buffer data operand (the update values)
                others = [o for o in u.operands[1:] if o != nm]
                ob = min((comp.by_name[o].result_bytes for o in others
                          if o in comp.by_name), default=u.result_bytes)
                per += ob
                work.append(u.name)
            else:
                return None
    return per


def _fusion_result_bytes(op: HloOp, comps: Dict[str, HloComputation]) -> int:
    """In-place DUS fusions write only the update region."""
    m = re.search(r"calls=%?([\w.\-]+)", op.attrs)
    called = comps.get(m.group(1)) if m else None
    if called and called.ops:
        root = called.ops[-1]
        if root.opcode == "dynamic-update-slice" and len(root.operands) > 1:
            upd = called.by_name.get(root.operands[1])
            if upd is not None:
                return upd.result_bytes
    return op.result_bytes


def hlo_hbm_bytes_estimate(text: str) -> float:
    """HBM traffic estimate: bytes crossing fusion/collective boundaries in
    the entry and loop-body computations, scaled by trip multipliers.

    dynamic-slice charges the slice (not the sliced buffer); in-place
    dynamic-update-slice charges read+write of the update region only."""
    comps = parse_hlo(text)
    mult = computation_multipliers(comps)
    # NOTE: `copy` is excluded — XLA CPU materializes while-carry copies
    # that TPU input/output aliasing elides; charging them would bill the
    # target for a host-backend artifact.
    _BOUNDARY = {"fusion", "dot", "convolution",
                 "custom-call"} | COLLECTIVE_OPS
    total = 0.0
    for comp in comps.values():
        m0 = mult.get(comp.name, 0.0)
        if m0 <= 0:
            continue
        for op in comp.ops:
            oc = op.opcode
            if oc == "dynamic-slice":
                total += m0 * 2 * op.result_bytes
            elif oc == "dynamic-update-slice":
                upd = (comp.by_name.get(op.operands[1])
                       if len(op.operands) > 1 else None)
                ub = upd.result_bytes if upd else op.result_bytes
                total += m0 * 2 * ub
            elif oc == "fusion":
                total += m0 * (_fusion_result_bytes(op, comps) +
                               _fusion_read_bytes(comp, op, comps))
            elif oc in _BOUNDARY:
                total += m0 * (op.result_bytes + _operand_bytes(comp, op))
    return total
