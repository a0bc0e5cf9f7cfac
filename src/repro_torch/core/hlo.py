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


# ------------------------------------------------------------- temp bytes
#
# XLA's ``memory_analysis().temp_size_in_bytes`` is the size of the heap that
# buffer assignment lays the module's temporaries out in.  ``hlo_temp_bytes``
# replays that assignment on a scheduled module's text (see its docstring).

_LEAF_TYPE_RE = re.compile(r"([a-z]\w*)\[([^\]]*)\](?:\{[^}]*\})?")
_SAME_VALUE = {"bitcast", "get-tuple-element", "tuple", "opt-barrier",
               "add-dependency"}
_IN_PLACE = {"dynamic-update-slice", "scatter"}
_ELEMENTWISE = {
    "abs", "add", "and", "ceil", "clamp", "compare", "convert", "cosine",
    "divide", "exponential", "exponential-minus-one", "floor", "is-finite",
    "log", "log-plus-one", "logistic", "maximum", "minimum", "multiply",
    "negate", "not", "or", "power", "remainder", "round-nearest-even",
    "rsqrt", "select", "shift-left", "shift-right-logical", "sign", "sine",
    "sqrt", "subtract", "tanh", "xor"}


def _type_tree(type_str: str):
    """An HLO type as a tree: a leaf's byte count, or a list of subtrees
    (a tuple)."""
    s = type_str.strip()

    def parse(i):
        while i < len(s) and s[i] in " ,":
            i += 1
        if s[i] != "(":
            m = _LEAF_TYPE_RE.match(s, i)
            # a dynamic dimension ("<=8") counts at its bound
            n = math.prod(int(d.strip().lstrip("<=")) for d in
                          m.group(2).split(",") if d.strip())
            return n * _ITEMSIZE.get(m.group(1), 0), m.end()
        out, i = [], i + 1
        while True:
            while s[i] in " ,":
                i += 1
            if s[i] == ")":
                return out, i + 1
            if s.startswith("/*", i):
                i = s.index("*/", i) + 2
                continue
            sub, i = parse(i)
            out.append(sub)

    return parse(0)[0] if s else 0


def _leaves(tree, path=()):
    if isinstance(tree, list):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, path + (i,))
    else:
        yield path, tree


def _subtree(tree, path):
    for i in path:
        tree = tree[i]
    return tree


def _attr(attrs: str, key: str) -> Optional[str]:
    m = re.search(key + r"=%?([\w.\-]+)", attrs)
    return m.group(1) if m else None


def _param_number(op: HloOp) -> int:
    return int(re.search(r"parameter\((\d+)\)", op.line).group(1))


def _called(op: HloOp) -> List[str]:
    """The computations a control-flow instruction runs (a fusion's body and
    a reduction's ``to_apply`` are not among them: they own no buffer)."""
    if op.opcode == "while":
        return [_attr(op.attrs, "condition"), _attr(op.attrs, "body")]
    if op.opcode == "call":
        return [_attr(op.attrs, "to_apply")]
    if op.opcode == "conditional":
        m = re.search(r"branch_computations=\{([^}]*)\}", op.attrs)
        if m:
            return [b.strip().lstrip("%") for b in m.group(1).split(",")]
        return [_attr(op.attrs, "true_computation"),
                _attr(op.attrs, "false_computation")]
    return []


class _UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, x):
        parent = self.parent
        root = x
        while parent.get(root, root) != root:
            root = parent[root]
        while x != root:
            parent[x], x = root, parent.get(x, x)
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def _donated_parameters(text: str) -> Dict[int, tuple]:
    """``input_output_alias`` of the module header: parameter number ->
    the output index it is donated to."""
    header = text.split("\n", 1)[0]
    m = re.search(r"input_output_alias=\{(.*?)\}\s*,\s*\w+=", header)
    out = {}
    if m:
        for index, param in re.findall(r"\{([\d,\s]*)\}:\s*\((\d+),",
                                       m.group(1)):
            out[int(param)] = tuple(int(x) for x in index.split(",")
                                    if x.strip())
    return out


def hlo_temp_bytes(text: str) -> int:
    """Temp bytes of a scheduled HLO module (``is_scheduled=true``): XLA's
    ``temp_size_in_bytes``, replayed from the text by the rules of XLA's
    buffer assignment.

    * *Values and buffers.*  ``bitcast``, ``get-tuple-element``, ``tuple``
      and ``opt-barrier`` define no value.  A ``while``'s init, its body's
      and condition's parameters, its body's root and its result share one
      buffer; an element the body passes through unchanged is one value.
      A ``call``'s parameters are its operands and its result its callee's
      root; a ``conditional``'s branch roots share its result's buffer.
      ``dynamic-update-slice`` and ``scatter``, bare or as a fusion's root
      (through bitcasts) on a fusion parameter of the same shape, write in
      their operand's buffer.  ``*-done`` is its ``*-start``'s result.
    * *Schedule.*  A called computation's instructions run just before the
      instruction that calls it (XLA's flattened module schedule).
    * *Live ranges.*  A value lives from its definition (a subcomputation's
      parameter from the computation's start) to its last use; a ``while``
      uses its init only up to its body's start; a computation's root lives
      to the computation's end, the entry's to the end of the module.  An
      elementwise instruction, or a fusion whose parameter only feeds
      elementwise operations, takes over the buffer of a same-shaped
      operand that dies there.
    * *Allocations.*  Entry parameters, constants and the entry's outputs
      are not temp.  Visited in decreasing size, a temp buffer moves into
      a donated parameter's (``input_output_alias``) or an output's
      allocation if it fits and meets none of its buffers (XLA's
      ``MaybeAssignBuffer``); the rest share the heap, whose size is the
      peak over the schedule of the live buffers' bytes, each buffer
      counted once over the union of its values' ranges.

    Alignment and the heap's fragmentation are not modelled: on the
    fixtures of ``configs/hlo/dryrun/`` (``tests/test_torch_dryrun.py``)
    the result is within 1.2% of XLA's."""
    comps = parse_hlo(text)
    entry = next(c for c in comps.values() if c.is_entry)
    types = {(c.name, op.name): _type_tree(op.type_str)
             for c in comps.values() for op in c.ops}
    root_of, params = {}, {}
    for c in comps.values():
        for op in c.ops:
            if op.line.lstrip().startswith("ROOT"):
                root_of[c.name] = op.name
            if op.opcode == "parameter":
                params[(c.name, _param_number(op))] = op.name
    val, buf = _UnionFind(), _UnionFind()

    def same(a, b):
        val.union(a, b)
        buf.union(a, b)

    loops = []
    for c in comps.values():
        for op in c.ops:
            tree, oc = types[(c.name, op.name)], op.opcode
            at = lambda p, _c=c.name, _o=op.name: (_c, _o, p)   # noqa: E731
            of = lambda i, p, _c=c.name, _o=op: (_c, _o.operands[i], p)  # noqa: E731,E501
            if oc in ("bitcast", "opt-barrier", "add-dependency"):
                for p, _ in _leaves(tree):
                    same(at(p), of(0, p))
            elif oc == "get-tuple-element":
                i = int(re.search(r"index=(\d+)", op.attrs).group(1))
                for p, _ in _leaves(tree):
                    same(at(p), of(0, (i,) + p))
            elif oc == "tuple":
                for i, o in enumerate(op.operands):
                    for p, _ in _leaves(types[(c.name, o)]):
                        same(at((i,) + p), (c.name, o, p))
            elif oc.endswith("-done") and op.operands:
                start = types[(c.name, op.operands[0])]
                src = (1,) if isinstance(start, list) and len(start) > 1 \
                    else ()
                for p, _ in _leaves(tree):
                    same(at(p), of(0, src + p))
            elif oc == "while":
                loops.append((c, op))
            elif oc == "call":
                callee = _called(op)[0]
                for i, o in enumerate(op.operands):
                    for p, _ in _leaves(types[(c.name, o)]):
                        same((callee, params[(callee, i)], p), (c.name, o, p))
                for p, _ in _leaves(tree):
                    same(at(p), (callee, root_of[callee], p))
            elif oc == "conditional":
                for k, branch in enumerate(_called(op)):
                    for p, _ in _leaves(types[(c.name, op.operands[k + 1])]):
                        same((branch, params[(branch, 0)], p),
                             of(k + 1, p))
                    for p, _ in _leaves(tree):
                        buf.union(at(p), (branch, root_of[branch], p))
            elif oc in _IN_PLACE:
                buf.union(at(()), of(0, ()))
            elif oc == "fusion":
                body = comps[_attr(op.attrs, "calls")]
                root = body.by_name[root_of[body.name]]
                outs = [((), root)] if root.opcode != "tuple" else \
                    [((i,), body.by_name[o]) for i, o in
                     enumerate(root.operands)]
                for p, r in outs:
                    while r.opcode == "bitcast":
                        r = body.by_name[r.operands[0]]
                    if r.opcode not in _IN_PLACE:
                        continue
                    src = body.by_name[r.operands[0]]
                    while src.opcode == "bitcast":
                        src = body.by_name[src.operands[0]]
                    if src.opcode == "parameter":
                        k = _param_number(src)
                        if types[(c.name, op.operands[k])] == \
                                _subtree(tree, p):
                            buf.union(at(p), of(k, ()))
    # while elements, once every same-value link inside the bodies is known
    for c, op in loops:
        cond, body = _called(op)
        for p, _ in _leaves(types[(c.name, op.name)]):
            init = (c.name, op.operands[0], p)
            body_param = (body, params[(body, 0)], p)
            ends = [(cond, params[(cond, 0)], p), (c.name, op.name, p),
                    (body, root_of[body], p), body_param]
            invariant = val.find(ends[2]) == val.find(body_param)
            for x in ends:
                (same if invariant else buf.union)(init, x)

    # the flattened schedule
    time, span, seq = {}, {}, []

    def flatten(name):
        first = len(seq)
        for op in comps[name].ops:
            for callee in _called(op):
                flatten(callee)
            time[(name, op.name)] = len(seq)
            seq.append((name, op))
        span[name] = (first, len(seq) - 1)

    flatten(entry.name)
    end = len(seq) - 1

    # live ranges of values
    start, last, size, kind = {}, {}, {}, {}

    def live(v, t0, t1):
        start[v] = min(start.get(v, t0), t0)
        last[v] = max(last.get(v, t1), t1)

    for name, op in seq:
        t = time[(name, op.name)]
        tree = types[(name, op.name)]
        defines = op.opcode not in _SAME_VALUE and op.opcode != "while" \
            and not (op.opcode.endswith("-done") and op.operands)
        t0 = t
        if op.opcode == "parameter":
            t0 = 0 if name == entry.name else span[name][0]
        for p, nbytes in _leaves(tree):
            v = val.find((name, op.name, p))
            if op.opcode == "while" and \
                    v != val.find((name, op.operands[0], p)):
                defines_here = True                      # the loop's result
            else:
                defines_here = defines
            if defines_here:
                size[v] = max(size.get(v, 0), nbytes)
            live(v, t0, t)
            if root_of.get(name) == op.name:
                live(v, t, span[name][1])
            if name == entry.name and op.opcode == "parameter":
                kind[buf.find(v)] = "parameter"
            if op.opcode == "constant":
                kind[buf.find(v)] = "constant"
        if op.opcode in ("tuple", "get-tuple-element", "bitcast"):
            continue
        use_at = span[_called(op)[1]][0] if op.opcode == "while" else t
        for o in op.operands:
            if (name, o) in types:
                for p, _ in _leaves(types[(name, o)]):
                    live(val.find((name, o, p)), use_at, use_at)
    out_root = root_of[entry.name]
    for p, _ in _leaves(types[(entry.name, out_root)]):
        v = val.find((entry.name, out_root, p))
        kind[buf.find(v)] = "output"
        live(v, start.get(v, end), end)

    # an elementwise result takes over a same-shaped operand dying there
    users: Dict[tuple, List[HloOp]] = {}
    for c in comps.values():
        for op in c.ops:
            for o in op.operands:
                users.setdefault((c.name, o), []).append(op)

    def elementwise_only(body: HloComputation, param: str) -> bool:
        stack, seen = [param], set()
        while stack:
            cur = stack.pop()
            seen.add(cur)
            for u in users.get((body.name, cur), []):
                if u.opcode not in _ELEMENTWISE and u.opcode != "tuple":
                    return False
                if u.name not in seen:
                    stack.append(u.name)
        return True

    for name, op in seq:
        tree = types[(name, op.name)]
        if isinstance(tree, list) or op.opcode not in _ELEMENTWISE | \
                {"fusion"}:
            continue
        v, t = val.find((name, op.name, ())), time[(name, op.name)]
        if kind.get(buf.find(v)) or start.get(v) != t:
            continue
        for k, o in enumerate(op.operands):
            operand = comps[name].by_name.get(o)
            if operand is None or types[(name, o)] != tree:
                continue
            u = val.find((name, o, ()))
            if u == v or kind.get(buf.find(u)) or last.get(u) != t:
                continue
            if op.opcode == "fusion":
                body = comps[_attr(op.attrs, "calls")]
                ok = operand.type_str.split("[")[0] == \
                    op.type_str.split("[")[0] and \
                    elementwise_only(body, params[(body.name, k)])
            else:
                ok = operand.type_str == op.type_str
            if ok:
                start[v], last[u] = t + 0.5, t - 0.5
                break

    # buffers: the union of their values' ranges (end exclusive)
    ranges: Dict[tuple, list] = {}
    for v, nbytes in size.items():
        ranges.setdefault(buf.find(v), []).append(
            (start[v], last[v] + 1, nbytes))
    donated = _donated_parameters(text)
    allocations = []
    for k, donee in donated.items():
        pb = buf.find((entry.name, params[(entry.name, k)], ()))
        ob = buf.find((entry.name, out_root, donee))
        allocations.append(ranges.get(pb, []) + ranges.get(ob, []))
    donees = {buf.find((entry.name, out_root, o)) for o in donated.values()}
    for p, _ in _leaves(types[(entry.name, out_root)]):
        ob = buf.find((entry.name, out_root, p))
        if ob not in donees:
            allocations.append(list(ranges.get(ob, [])))
    capacity = [max([r[2] for r in a] or [0]) for a in allocations]
    by_size = sorted(range(len(allocations)), key=capacity.__getitem__)
    heap = []
    temps = [b for b in ranges if not kind.get(b)]
    for b in sorted(temps, key=lambda b: -max(r[2] for r in ranges[b])):
        mine = ranges[b]
        nbytes = max(r[2] for r in mine)
        for i in by_size:
            if capacity[i] >= nbytes and not any(
                    s0 < e1 and s1 < e0 for s0, e0, _ in mine
                    for s1, e1, _ in allocations[i]):
                allocations[i].extend(mine)
                break
        else:
            heap.append((nbytes, sorted(mine)))
    events = []
    for nbytes, spans in heap:
        s0, e0 = spans[0][:2]
        for s1, e1, _ in spans[1:]:
            if s1 <= e0:
                e0 = max(e0, e1)
            else:
                events += [(s0, nbytes), (e0, -nbytes)]
                s0, e0 = s1, e1
        events += [(s0, nbytes), (e0, -nbytes)]
    cur = peak = 0
    for _, delta in sorted(events):
        cur += delta
        peak = max(peak, cur)
    return peak
