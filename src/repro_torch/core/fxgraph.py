"""PyTorch-graph frontend — array-granularity eDAG of a PyTorch program.

The counterpart of the reference package's jaxpr frontend.  A program is
captured once, abstractly, as a functionalized pre-dispatch ATen graph
(``torch.export.export`` followed by ``run_decompositions({})``): every
input is replaced by a fake tensor, so no data is touched and no kernel
runs, whatever device the arguments live on (``cuda``, ``cpu`` or
``meta`` give the same eDAG).  Pre-dispatch capture keeps ``matmul`` and
``einsum`` whole, as a jaxpr keeps ``dot_general`` whole.

Vertices are ATen nodes; edges are SSA true dependencies.  The reference's
rules hold, each cited at its line in ``core/jaxpr.py``:

* one vertex per node; nodes that do no array work (``getitem`` of a
  multi-output node, ``detach``, ``alias``, symbolic-size and assert
  nodes) forward their producer and add none;
* labels are the jaxpr primitive names of the ATen ops (``_LABELS``); an
  op with no counterpart keeps its ATen name;
* cost: 2·out·K for contractions, input elements for reductions, output
  elements otherwise, floor 1;
* bytes: the tensor inputs' and outputs' bytes, Python scalars excluded;
  a vertex is a memory-access vertex when its bytes exceed
  ``mem_threshold_bytes``;
* ``scan`` is unrolled up to ``scan_unroll_limit`` steps with carry and
  stacked-ys wiring; ``cond`` keeps its costliest branch; call-like
  higher-order ops are inlined.  Any other higher-order op raises
  ``NotImplementedError`` naming it: none becomes one opaque vertex.
"""
from __future__ import annotations

import math
import operator
from functools import reduce
from typing import Dict, Optional

import torch
import torch.fx

from .graph import EDag

_ELEMENTWISE_COST = 1.0

#: ATen op (overload packet name) -> the jaxpr primitive the reference
#: labels the same array operation with.
_LABELS = {
    **dict.fromkeys(("mm", "mv", "bmm", "matmul", "einsum", "dot", "vdot",
                     "linear", "addmm", "addmv", "baddbmm", "addbmm",
                     "tensordot"), "dot_general"),
    **dict.fromkeys(("permute", "t", "transpose", "numpy_T", "mT",
                     "swapaxes", "swapdims", "adjoint"), "transpose"),
    "sum": "reduce_sum", "amax": "reduce_max", "amin": "reduce_min",
    "rsub": "sub", "true_divide": "div", "maximum": "max",
    "minimum": "min", "sigmoid": "logistic", "where": "select_n",
    **dict.fromkeys(("view", "reshape", "_unsafe_view", "view_as",
                     "flatten", "unflatten"), "reshape"),
    **dict.fromkeys(("expand", "expand_as", "broadcast_to", "unsqueeze",
                     "zeros", "ones", "full", "empty", "zeros_like",
                     "ones_like", "full_like", "empty_like", "new_zeros",
                     "new_ones", "new_full", "new_empty",
                     "scalar_tensor"), "broadcast_in_dim"),
    **dict.fromkeys(("_to_copy", "to", "type_as"), "convert_element_type"),
    **dict.fromkeys(("clone", "copy"), "copy"),
    **dict.fromkeys(("cat", "concat", "concatenate"), "concatenate"),
    **dict.fromkeys(("index", "index_select", "gather"), "gather"),
    **dict.fromkeys(("index_add", "scatter_add", "index_put"),
                    "scatter-add"),
    **dict.fromkeys(("scatter", "select_scatter", "slice_scatter"),
                    "scatter"),
    "arange": "iota", "flip": "rev", "constant_pad_nd": "pad",
    "logical_and": "and", "logical_or": "or", "logical_not": "not",
}

#: contraction ops: (index of the operand whose dim holds K, that dim)
_CONTRACT = {
    "mm": (0, -1), "bmm": (0, -1), "matmul": (0, -1), "mv": (0, -1),
    "linear": (0, -1), "dot": (0, 0), "vdot": (0, 0), "addmm": (1, -1),
    "addmv": (1, -1), "baddbmm": (1, -1), "addbmm": (1, -1),
}
_REDUCTIONS = ("reduce_sum", "reduce_max", "reduce_min", "argmax", "argmin")

#: nodes that do no array work: they forward their producer
_FORWARD = ("detach", "alias", "lift_fresh_copy", "lift_fresh")

#: call-like higher-order ops whose subgraph is inlined transparently, the
#: counterpart of ``_CALL_PRIMS`` (jaxpr.py:72): nested compile regions,
#: ``torch.utils.checkpoint`` bodies and export's grad-mode and autocast
#: wrappers
_CALL_HOPS = ("invoke_subgraph", "wrap", "tag_activation_checkpoint",
              "wrap_with_set_grad_enabled", "wrap_with_autocast")


def _tensors(val) -> list:
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [t for v in val for t in _tensors(v)]
    return []


def _numel(t) -> float:
    return float(math.prod(t.shape))


def _bytes(t) -> float:
    # jaxpr.py:26-30 _aval_bytes
    return float(math.prod(t.shape) * t.element_size())


def _packet(node) -> str:
    target = node.target
    if isinstance(target, torch._ops.OpOverload):
        return target.overloadpacket.__name__
    if isinstance(target, torch._ops.OpOverloadPacket):
        return target.__name__
    return getattr(target, "__name__", str(target))


def _label(node) -> str:
    name = _packet(node)
    if name in ("max", "min"):
        overload = getattr(node.target, "_overloadname", "")
        return name if overload == "other" else f"reduce_{name}"
    return _LABELS.get(name, name)


def _hop_name(node) -> Optional[str]:
    if isinstance(node.target, torch._ops.HigherOrderOperator):
        return node.target.name()
    return None


class _Frame:
    """One graph being walked: its module (for ``get_attr``) and its env
    from fx node to producing vertex (an int, None for inputs and
    constants, or a list for a multi-output higher-order op)."""

    def __init__(self, gm: torch.fx.GraphModule) -> None:
        self.gm = gm
        self.env: Dict[torch.fx.Node, object] = {}

    def attr(self, node):
        return reduce(getattr, node.target.split("."), self.gm)

    def val(self, node):
        v = node.meta.get("val")
        if v is None and node.op == "get_attr":
            v = self.attr(node)
        return v

    def inputs(self, node) -> list:
        """Tensor input occurrences of ``node`` (duplicates kept, as the
        reference iterates ``eqn.invars``)."""
        out = []
        torch.fx.map_arg((node.args, node.kwargs), out.append)
        return [a for a in out if isinstance(self.val(a), torch.Tensor)]


def _node_flops(frame: _Frame, node, label: str) -> float:
    """Coarse per-node cost (jaxpr.py:33-65 ``_eqn_flops``): 2·out·K for a
    contraction, input elements for a reduction, output elements
    otherwise, with a unit floor."""
    out_elems = sum(_numel(t) for t in _tensors(frame.val(node)))
    if label == "dot_general":
        k = _contraction_extent(frame, node)
        return max(2.0 * out_elems * k, 1.0)
    if label in _REDUCTIONS:
        in_elems = sum(_numel(frame.val(a)) for a in frame.inputs(node))
        return max(in_elems, 1.0)
    return max(out_elems * _ELEMENTWISE_COST, 1.0)


def _contraction_extent(frame: _Frame, node) -> float:
    """K of a contraction: from the operand's contracting dim, or for an
    einsum from the equation (letters shared by operands and absent from
    the output)."""
    name = _packet(node)
    if name == "einsum":
        eq = node.args[0].replace(" ", "")
        ops = [frame.val(a) for a in node.args[1]]
        lhs, arrow, rhs = eq.partition("->")
        terms = lhs.split(",")
        if not arrow:                   # implicit output: letters seen once
            counts = {c: lhs.count(c) for c in lhs if c.isalpha()}
            rhs = "".join(sorted(c for c, n in counts.items() if n == 1))
        sizes, seen = {}, {}
        for term, t in zip(terms, ops):
            letters = term.replace("...", "")
            dims = list(t.shape)
            if "..." in term:           # ellipsis dims lead or trail
                head = term.index("...")
                dims = dims[:head] + dims[len(dims) - (len(letters) - head):]
            for c, d in zip(letters, dims):
                sizes[c] = d
                seen[c] = seen.get(c, 0) + 1
        return float(math.prod(sizes[c] for c, n in seen.items()
                               if n > 1 and c not in rhs))
    if name == "tensordot":
        a, dims = frame.val(node.args[0]), node.args[2]
        return float(math.prod(a.shape[d] for d in dims))
    i, dim = _CONTRACT.get(name, (0, -1))
    t = frame.val(frame.inputs(node)[i])
    return float(t.shape[dim]) if t.dim() else 1.0


def _subgraph(frame: _Frame, node) -> tuple:
    """(graph module, operand args) of a call-like higher-order op: the
    first argument naming a graph module, then its operands after any
    identifier strings."""
    for i, a in enumerate(node.args):
        if isinstance(a, torch.fx.Node) and a.op == "get_attr" and \
                isinstance(frame.attr(a), torch.fx.GraphModule):
            rest = list(node.args[i + 1:])
            while rest and isinstance(rest[0], str):
                rest.pop(0)
            return frame.attr(a), rest
    raise NotImplementedError(
        f"higher-order op {_hop_name(node)!r} holds no subgraph")


def _scan_parts(frame: _Frame, node) -> tuple:
    """(body, init, xs, additional inputs) of a ``scan`` node, whose body
    takes the carries, one slice of each xs, then the additional inputs
    (closed-over tensors and sizes)."""
    body, init, xs, adds = node.args[:4]
    return frame.attr(body), list(init), list(xs), list(adds)


def _scan_length(frame: _Frame, xs) -> int:
    return int(frame.val(xs[0]).shape[0]) if xs else 0


def _cond_branches(frame: _Frame, node) -> tuple:
    """The branches in jax's index order (0 = false, 1 = true), so that a
    cost tie keeps the branch the reference keeps, and the operands."""
    _, true_g, false_g, operands = node.args[:4]
    return (frame.attr(false_g), frame.attr(true_g)), list(operands)


def _graph_cost(gm: torch.fx.GraphModule, limit: int) -> float:
    """Total cost of a (sub)graph under the walker's traversal rules
    (jaxpr.py:77-101 ``_jaxpr_cost``): scans count ``min(length, limit)``
    body repeats, call-like ops inline, ``cond`` counts its costliest
    branch."""
    frame = _Frame(gm)
    total = 0.0
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        hop = _hop_name(node)
        if hop == "scan":
            body, _, xs, _ = _scan_parts(frame, node)
            steps = min(_scan_length(frame, xs), limit)
            total += steps * _graph_cost(body, limit)
        elif hop == "cond":
            branches, _ = _cond_branches(frame, node)
            total += max(_graph_cost(b, limit) for b in branches)
        elif hop in _CALL_HOPS:
            total += _graph_cost(_subgraph(frame, node)[0], limit)
        elif hop is not None:
            raise NotImplementedError(f"higher-order op {hop!r}")
        elif _is_vertex(frame, node):
            total += _node_flops(frame, node, _label(node))
    return total


def _is_vertex(frame: _Frame, node) -> bool:
    """An ATen node that does array work: it yields a tensor and is not a
    forwarding node."""
    if node.target is operator.getitem or _packet(node) in _FORWARD:
        return False
    return bool(_tensors(frame.val(node)))


class _Walker:
    def __init__(self, g: EDag, mem_threshold_bytes: float,
                 scan_unroll_limit: int) -> None:
        self.g = g
        self.thresh = mem_threshold_bytes
        self.limit = scan_unroll_limit

    def run(self, gm: torch.fx.GraphModule, inputs: list) -> list:
        """Walk ``gm`` with its placeholders bound to ``inputs`` (producing
        vertices); return the producers of its flattened outputs."""
        frame = _Frame(gm)
        env = frame.env
        slots = iter(inputs)
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(slots, None)
            elif node.op == "get_attr":
                env[node] = None           # constants: no producing vertex
            elif node.op == "output":
                return [env.get(o) if isinstance(o, torch.fx.Node) else None
                        for o in _flat_outputs(node.args[0])]
            elif node.op == "call_function":
                self._call(frame, node)
            else:
                raise NotImplementedError(
                    f"{node.op} node {node.target!r}: edag_from_graph takes "
                    f"ATen graphs (torch.export, make_fx)")
        return []

    def _call(self, frame: _Frame, node) -> None:
        env = frame.env
        hop = _hop_name(node)
        if node.target is operator.getitem:
            src, idx = node.args
            dep = env.get(src)
            env[node] = dep[idx] if isinstance(dep, list) else dep
            return
        if hop is not None:
            outs = self._hop(frame, node, hop)
            env[node] = outs if not isinstance(
                frame.val(node), torch.Tensor) else outs[0]
            return
        if isinstance(node.target, torch._ops.OpOverload) and \
                node.target._schema.is_mutable:
            raise NotImplementedError(
                f"in-place op {node.target}: functionalize the graph first "
                f"(edag_from_fn captures a functional one)")
        if _packet(node) in _FORWARD:
            ins = frame.inputs(node)
            env[node] = env.get(ins[0]) if ins else None
            return
        if not _tensors(frame.val(node)):
            env[node] = None               # symbolic sizes, asserts
            return
        self._emit(frame, node)

    def _emit(self, frame: _Frame, node) -> None:
        # jaxpr.py:154-168 _emit: tensor inputs' and outputs' bytes, Python
        # scalars excluded; one edge per tensor input from its producer
        ins = frame.inputs(node)
        nbytes = sum(_bytes(frame.val(a)) for a in ins)
        nbytes += sum(_bytes(t) for t in _tensors(frame.val(node)))
        label = _label(node)
        vid = self.g.add_vertex(cost=_node_flops(frame, node, label),
                                is_mem=nbytes > self.thresh,
                                nbytes=nbytes, label=label)
        for a in ins:
            dep = frame.env.get(a)
            if dep is not None and dep < vid:
                self.g.add_edge(dep, vid)
        frame.env[node] = vid

    def _producers(self, frame: _Frame, args) -> list:
        return [frame.env.get(a) if isinstance(a, torch.fx.Node) else None
                for a in args]

    def _hop(self, frame: _Frame, node, hop: str) -> list:
        if hop == "scan":
            return self._scan(frame, node)
        if hop == "cond":
            # jaxpr.py:120-131: a static eDAG keeps one side of a
            # data-dependent branch, the costliest (ties to the first in
            # jax's order); the predicate feeds no branch vertex
            branches, operands = _cond_branches(frame, node)
            sub = max(branches, key=lambda b: _graph_cost(b, self.limit))
            return self.run(sub, self._producers(frame, operands))
        if hop in _CALL_HOPS:
            # jaxpr.py:68-74 _CALL_PRIMS: inlined, never an opaque vertex
            sub, operands = _subgraph(frame, node)
            return self.run(sub, self._producers(frame, operands))
        raise NotImplementedError(
            f"higher-order op {hop!r} is not handled by the PyTorch-graph "
            f"frontend")

    def _scan(self, frame: _Frame, node) -> list:
        # jaxpr.py:170-207 _scan: unroll min(length, limit) steps, carries
        # chained step to step, stacked ys wired to the final step's
        # producers
        body, init, xs, adds = _scan_parts(frame, node)
        steps = min(_scan_length(frame, xs), self.limit)
        n_carry = len(init)
        carry = self._producers(frame, init)
        xs_v = self._producers(frame, xs)
        adds_v = self._producers(frame, adds)
        outs: list = []
        for _ in range(steps):
            outs = self.run(body, carry + xs_v + adds_v)
            carry = outs[:n_carry]
        n_out = len(_tensors(frame.val(node)))
        ys = outs[n_carry:] if outs else [None] * (n_out - n_carry)
        return carry + ys


def _flat_outputs(arg) -> list:
    if isinstance(arg, (list, tuple)):
        return [x for a in arg for x in _flat_outputs(a)]
    return [arg]


class _Fn(torch.nn.Module):
    def __init__(self, fn) -> None:
        super().__init__()
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def capture(fn, *args, **kwargs) -> torch.fx.GraphModule:
    """The functionalized pre-dispatch ATen graph of ``fn(*args,
    **kwargs)``, traced with fake tensors (no data is read and no kernel
    runs, on any device).  An ``nn.Module``'s parameters and buffers become
    inputs."""
    mod = fn if isinstance(fn, torch.nn.Module) else _Fn(fn)
    ep = torch.export.export(mod, tuple(args), kwargs=kwargs or None,
                             strict=False)
    return ep.run_decompositions({}).graph_module


def edag_from_fn(fn, *args, mem_threshold_bytes: float = 0.0,
                 scan_unroll_limit: int = 64, **kwargs) -> EDag:
    """Capture ``fn(*args, **kwargs)`` abstractly (``capture``) and build
    its array-level eDAG.  Tracing never runs the program: arguments on
    ``cuda``, ``cpu`` or ``meta`` give the same eDAG, and no data moves.
    Non-tensor arguments are constants of the trace."""
    gm = capture(fn, *args, **kwargs)
    return edag_from_graph(gm, mem_threshold_bytes=mem_threshold_bytes,
                           scan_unroll_limit=scan_unroll_limit)


def edag_from_graph(gm, mem_threshold_bytes: float = 0.0,
                    scan_unroll_limit: int = 64) -> EDag:
    """The eDAG of a captured ATen graph (a ``torch.fx.GraphModule`` or a
    ``torch.export.ExportedProgram``), the counterpart of
    ``edag_from_jaxpr``.  Inputs, parameters and lifted constants have no
    producing vertex.  The graph must be functional (no in-place ops)."""
    if isinstance(gm, torch.export.ExportedProgram):
        gm = gm.graph_module
    g = EDag()
    _Walker(g, mem_threshold_bytes, scan_unroll_limit).run(gm, [])
    return g


__all__ = ["capture", "edag_from_fn", "edag_from_graph"]
