"""The port's PyTorch-graph frontend (``repro_torch.core.fxgraph``) against
the JAX package's jaxpr frontend, on the CPU.

Each program of ``tests/test_jaxpr.py`` is written in PyTorch and traced by
both frontends from the same shapes: vertices, edges, labels, ``cost``,
``nbytes``, ``is_mem``, ``trace_digest`` and ``report``'s W, D and t1 must
be equal.  Where the two frameworks decompose a program differently, the
difference is named and asserted (``NAMED``), never skipped:

* ``jax.jit``: compared with the reference's graph of the program without
  ``jit`` (the reference makes a jitted call one opaque vertex, ROADMAP §C
  2); neither ``PINS`` nor a model-trace digest is ground truth here;
* ``scan``: a torch scan body may not return one tensor as both carry and
  ys, so the ys is a ``copy`` (one vertex per step, no successor), and a
  carry init made in the program is a vertex where jax's ``jnp.float32``
  literal is none (the torch programs take it as an input);
* ``cond``: jax converts the predicate to the branch index
  (``convert_element_type``); torch has no such node, and ``x.T`` inside a
  branch cannot be captured (an aliasing error), so the branch writes
  ``x.t()``, the same transpose.

Then the apps' twins at small sizes and at the paper's (against
``configs/frontend_expected.json``), and the analyses: the port's
``report``, ``latency_sweep`` and ``sweep_grid`` on each twin's eDAG bit
for bit equal to the JAX package's on the same arrays, under both replay
policies.
"""
import json
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._higher_order_ops.scan import scan
from torch.utils import checkpoint as ckpt

import repro.core as R
import repro_torch.core as T
from repro.apps import hpcg as rhpcg
from repro.apps import lulesh as rlulesh
from repro.apps import polybench as rpoly
from repro_torch.apps import hpcg, lulesh, polybench

EXPECTED = json.loads((Path(T.__file__).resolve().parents[1] / "configs" /
                       "frontend_expected.json").read_text())
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from frontend_expected import MUST_AGREE, agreeing  # noqa: E402

# The twins whose decompositions agree, as the fixture recorded them.
AGREE = agreeing(EXPECTED)
POLICIES = ["float64", "float32"]
GRID_ALPHAS = [50.0, 113.5, 200.0, 300.0]


@pytest.fixture(autouse=True)
def cpu_backend(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")
    for knob in ("EDAN_X64", "EDAN_REPLAY_DTYPE", "EDAN_REPLAY_MEM_BUDGET"):
        monkeypatch.delenv(knob, raising=False)


def f32(a):
    return jnp.asarray(a, jnp.float32)


def meta(a):
    return torch.empty(np.shape(a), dtype=torch.float32, device="meta")


def arrays(g) -> dict:
    g.trace_digest()
    return dict(n=g.n_vertices, src=np.asarray(g.src).tolist(),
                dst=np.asarray(g.dst).tolist(), labels=list(g.labels()),
                cost=np.asarray(g.cost).tolist(),
                nbytes=np.asarray(g.nbytes).tolist(),
                is_mem=np.asarray(g.is_mem).tolist(),
                digest=g.trace_digest())


def assert_same(gt, gr) -> None:
    """Equal eDAGs, and equal report W, D and t1."""
    assert arrays(gt) == arrays(gr)
    rt, rr = T.report(gt), R.report(gr)
    assert (rt.W, rt.D, rt.t1) == (rr.W, rr.D, rr.t1)


def dropped(g, label: str) -> dict:
    """``g``'s arrays without its ``label`` vertices, which must have no
    successor (vertex ids renumbered, edges into them dropped)."""
    a = arrays(g)
    keep = np.array([lb != label for lb in a["labels"]])
    assert not any(not keep[s] for s in a["src"]), f"a {label} has a user"
    new = np.cumsum(keep) - 1
    edges = [(int(new[s]), int(new[d])) for s, d in zip(a["src"], a["dst"])
             if keep[d]]
    return dict(n=int(keep.sum()), edges=edges,
                **{k: [v for v, f in zip(a[k], keep) if f]
                   for k in ("labels", "cost", "nbytes", "is_mem")})


# ------------------------------------------------ tests/test_jaxpr.py cases

def dot_plus_one(**kw):
    return (T.edag_from_fn(lambda a, b: a @ b + 1.0, torch.ones(4, 8),
                           torch.ones(8, 3), **kw),
            R.edag_from_fn(lambda a, b: jnp.dot(a, b) + 1.0,
                           jnp.ones((4, 8)), jnp.ones((8, 3)), **kw))


def test_dot_plus_one_shape_and_costs():
    gt, gr = dot_plus_one()
    assert_same(gt, gr)
    assert (gt.n_vertices, gt.n_edges) == (2, 1)
    assert list(gt.labels()) == ["dot_general", "add"]
    assert list(gt.cost) == [2.0 * 4 * 3 * 8, 4 * 3 * 1.0]
    assert list(gt.nbytes) == [(32 + 24 + 12) * 4.0, (12 + 12) * 4.0]
    assert T.report(gt).t1 == 192.0 + 12.0 + 196.0
    assert len(gt.trace_digest()) == 64


def test_digest_stable_and_compiled_call_transparent():
    """Same program => same digest across rebuilds, and a compiled call
    (``torch.compile``, a nested compile region called twice, which strict
    export keeps as ``invoke_subgraph``) is inlined: equal to the
    reference's graph of the program without ``jax.jit``."""
    gt, gr = dot_plus_one()
    assert dot_plus_one()[0].trace_digest() == gt.trace_digest()
    f = torch.compile(lambda a, b: a @ b + 1.0)
    gc = T.edag_from_fn(f, torch.ones(4, 8), torch.ones(8, 3))
    assert_same(gc, gr)

    region = torch.compiler.nested_compile_region(lambda a, b: a @ b + 1.0)

    class Twice(torch.nn.Module):
        def forward(self, a, b):
            return region(a, b) * region(a, b)
    ep = torch.export.export(Twice(), (torch.ones(4, 8), torch.ones(8, 3)),
                             strict=True)
    hops = {str(n.target) for n in ep.graph.nodes}
    g2 = T.edag_from_graph(ep)
    f2 = lambda a, b: (jnp.dot(a, b) + 1.0) * (jnp.dot(a, b) + 1.0)  # noqa
    assert_same(g2, R.edag_from_fn(f2, jnp.ones((4, 8)), jnp.ones((8, 3))))
    assert any("invoke_subgraph" in h for h in hops)
    assert "invoke_subgraph" not in g2.labels()


@pytest.mark.parametrize("thresh", [0.0, 100.0, 200.0, 1e9])
def test_mem_threshold_reclassifies(thresh):
    gt, gr = dot_plus_one(mem_threshold_bytes=thresh)
    assert_same(gt, gr)
    if thresh == 1e9:
        assert gt.is_mem.sum() == 0
        assert gt.trace_digest() != dot_plus_one()[0].trace_digest()


def _jbody(c, x):
    c = c * 0.5 + x
    return c, c


def _tbody(c, x):
    c = c * 0.5 + x
    return c, c.clone()


@pytest.mark.parametrize("limit,steps", [(64, 10), (4, 4)])
def test_scan_unrolls_with_carry_depth(limit, steps):
    """NAMED: the torch body's ys is a copy of the carry (a ``copy`` vertex
    per step, with no successor); without them the graphs are equal.  The
    last step's copy hangs off the chain's end, one memory level more."""
    gr = R.edag_from_fn(lambda xs: jax.lax.scan(_jbody, jnp.float32(0.0),
                                                xs),
                        jnp.ones(10, jnp.float32), scan_unroll_limit=limit)
    gt = T.edag_from_fn(lambda c0, xs: scan(_tbody, c0, xs),
                        torch.zeros(()), torch.ones(10),
                        scan_unroll_limit=limit)
    assert Counter(gt.labels())["copy"] == steps
    assert dropped(gt, "copy") == dropped(gr, "copy")
    assert R.report(gr).D == 2 * steps
    assert T.report(gt).D == 2 * steps + 1


def test_scan_unroll_limit_zero_passes_the_carry_through():
    """No step is emitted: the carry's consumer reads the init's producer
    and the stacked ys has none."""
    jf = lambda c0, xs: jnp.sum(jax.lax.scan(  # noqa: E731
        _jbody, c0 * 2.0, xs)[0]) + 1.0
    tf = lambda c0, xs: torch.sum(scan(  # noqa: E731
        _tbody, c0 * 2.0, xs)[0]) + 1.0
    gr = R.edag_from_fn(jf, jnp.ones(()), jnp.ones(6), scan_unroll_limit=0)
    gt = T.edag_from_fn(tf, torch.ones(()), torch.ones(6),
                        scan_unroll_limit=0)
    assert_same(gt, gr)
    assert list(gt.labels()) == ["mul", "reduce_sum", "add"]


def test_scan_stacked_ys_wired_to_final_producers():
    def jbody(carry, x):
        c1, c2 = carry
        y = x * 3.0
        return (c1 + x, c2 - x), y

    def jf(xs):
        (c1, _), ys = jax.lax.scan(
            jbody, (jnp.float32(0.0), jnp.float32(1.0)), xs)
        return jnp.sum(ys) + c1

    def tf(c1_0, c2_0, xs):
        (c1, _), ys = scan(jbody, (c1_0, c2_0), xs)
        return torch.sum(ys) + c1

    gr = R.edag_from_fn(jf, jnp.ones(3, jnp.float32))
    gt = T.edag_from_fn(tf, torch.zeros(()), torch.ones(()), torch.ones(3))
    assert_same(gt, gr)
    labels = list(gt.labels())
    assert labels == ["mul", "add", "sub"] * 3 + ["reduce_sum", "add"]
    rid = labels.index("reduce_sum")
    assert {int(s) for s, d in zip(gt.src, gt.dst) if d == rid} == {6}


def _cond_pair(expensive_true: bool):
    big_t = lambda x: (x @ x.t()).sum()          # noqa: E731
    big_j = lambda x: jnp.sum(x @ x.T)           # noqa: E731
    small_t = lambda x: x.sum()                  # noqa: E731
    small_j = lambda x: jnp.sum(x)               # noqa: E731
    tt, tf_ = (big_t, small_t) if expensive_true else (small_t, big_t)
    jt, jf_ = (big_j, small_j) if expensive_true else (small_j, big_j)
    gt = T.edag_from_fn(
        lambda v: torch.cond(v.sum() > 0.0, tt, tf_, (v,)),
        torch.ones(8, 8))
    gr = R.edag_from_fn(
        lambda v: jax.lax.cond(jnp.sum(v) > 0.0, jt, jf_, v),
        jnp.ones((8, 8)))
    return gt, gr


@pytest.mark.parametrize("expensive_true", [True, False])
def test_cond_keeps_max_cost_branch(expensive_true):
    """NAMED: the reference's ``convert_element_type`` (predicate to branch
    index) has no torch node; without it the graphs are equal."""
    gt, gr = _cond_pair(expensive_true)
    assert list(gt.labels()) == ["reduce_sum", "gt", "transpose",
                                 "dot_general", "reduce_sum"]
    assert dropped(gt, "convert_element_type") == \
        dropped(gr, "convert_element_type")
    assert Counter(gr.labels())["convert_element_type"] == 1


def test_cond_tie_keeps_jax_index_0():
    """Equal-cost branches: both frontends keep the false branch (jax's
    branch 0)."""
    gt = T.edag_from_fn(lambda v: torch.cond(
        v.sum() > 0.0, lambda x: x.sum(), lambda x: x.amax(), (v,)),
        torch.ones(8, 8))
    gr = R.edag_from_fn(lambda v: jax.lax.cond(
        jnp.sum(v) > 0.0, jnp.sum, jnp.max, v), jnp.ones((8, 8)))
    assert list(gt.labels())[-1] == list(gr.labels())[-1] == "reduce_max"
    assert dropped(gt, "convert_element_type") == \
        dropped(gr, "convert_element_type")


@pytest.mark.parametrize("eq,sa,sb", [
    ("bmk,bkn->bmn", (2, 4, 8), (2, 8, 3)),
    ("...mk,...kn->...mn", (2, 4, 8), (2, 8, 3)),
    ("ij,jk->ik", (4, 8), (8, 3)),
    ("bij,bjk->bik", (3, 5, 2), (3, 2, 7)),
    ("ij,jk", (4, 8), (8, 3)),
])
def test_dot_general_batched_flops(eq, sa, sb):
    gt = T.edag_from_fn(lambda a, b: torch.einsum(eq, a, b), torch.ones(sa),
                        torch.ones(sb))
    gr = R.edag_from_fn(lambda a, b: jnp.einsum(eq, a, b), jnp.ones(sa),
                        jnp.ones(sb))
    assert_same(gt, gr)
    assert list(gt.labels()) == ["dot_general"]


@pytest.mark.parametrize("op,shapes", [
    ("mm", [(4, 8), (8, 3)]), ("bmm", [(2, 4, 8), (2, 8, 3)]),
    ("mv", [(4, 8), (8,)]), ("dot", [(8,), (8,)]),
    ("matmul", [(8,), (8, 3)]), ("matmul", [(2, 4, 8), (8, 3)]),
])
def test_contraction_flops_match_dot_general(op, shapes):
    """Each ATen contraction's cost is 2·out·K, as the reference's
    ``dot_general``."""
    fn = getattr(torch, op)
    jfn = {"mm": jnp.matmul, "bmm": jnp.matmul, "mv": jnp.matmul,
           "dot": jnp.dot, "matmul": jnp.matmul}[op]
    gt = T.edag_from_fn(fn, *[torch.ones(s) for s in shapes])
    gr = R.edag_from_fn(jfn, *[jnp.ones(s) for s in shapes])
    assert_same(gt, gr)


@pytest.mark.parametrize("dims", [([1], [0]), ([0, 2], [1, 0])])
def test_tensordot_flops_match_dot_general(dims):
    shapes = [(4, 8), (8, 3)] if len(dims[0]) == 1 else \
        [(3, 4, 5), (5, 3, 2)]
    gt = T.edag_from_fn(lambda a, b: torch.tensordot(a, b, dims=dims),
                        *[torch.ones(s) for s in shapes])
    gr = R.edag_from_fn(lambda a, b: jnp.tensordot(a, b, axes=dims),
                        *[jnp.ones(s) for s in shapes])
    assert_same(gt, gr)


def test_checkpoint_body_inlined_not_opaque():
    jf = jax.checkpoint(lambda x: jnp.sum(x * 2.0 + 1.0))
    gr = R.edag_from_fn(lambda x: jf(x) * 3.0, jnp.ones(16, jnp.float32))
    gt = T.edag_from_fn(lambda x: ckpt.checkpoint(
        lambda y: (y * 2.0 + 1.0).sum(), x, use_reentrant=False) * 3.0,
        torch.ones(16))
    assert_same(gt, gr)
    assert list(gt.labels()) == ["mul", "add", "reduce_sum", "mul"]


def test_grad_mode_and_autocast_wrappers_inlined():
    """Export wraps a ``no_grad`` or ``autocast`` region in a call-like
    higher-order op; the frontend inlines it."""
    def f(x):
        with torch.no_grad():
            y = x * 2.0
        return y + 1.0
    ep = torch.export.export(_Mod(f), (torch.ones(5),))
    assert any("wrap_with_set_grad_enabled" in str(n.target)
               for n in ep.graph.nodes)
    assert_same(T.edag_from_graph(ep),
                R.edag_from_fn(lambda x: x * 2.0 + 1.0, jnp.ones(5)))

    def g(x):
        with torch.autocast("cpu", dtype=torch.bfloat16):
            y = x @ x
        return y.float() + 1.0
    ep = torch.export.export(_Mod(g), (torch.ones(4, 4),))
    assert any("wrap_with_autocast" in str(n.target) for n in ep.graph.nodes)
    assert list(T.edag_from_graph(ep).labels()) == [
        "dot_general", "convert_element_type", "add"]


class _Mod(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def test_polybench_gemm_pinned():
    ones = [torch.ones(6, 6)] * 3
    gt = T.edag_from_fn(polybench.TORCH_KERNELS["gemm"], *ones)
    gr = R.edag_from_fn(rpoly.JAX_KERNELS["gemm"], *[jnp.ones((6, 6))] * 3)
    assert_same(gt, gr)
    assert list(gt.labels()) == ["mul", "dot_general", "mul", "add"]
    assert (T.report(gt).W, T.report(gt).D) == (4, 3)
    assert T.edag_from_fn(polybench.TORCH_KERNELS["gemm"],
                          *ones).trace_digest() == gt.trace_digest()


def test_polybench_atax_pinned():
    gt = T.edag_from_fn(polybench.TORCH_KERNELS["atax"], torch.ones(4, 6),
                        torch.ones(6))
    gr = R.edag_from_fn(rpoly.JAX_KERNELS["atax"], jnp.ones((4, 6)),
                        jnp.ones(6))
    assert_same(gt, gr)
    assert list(gt.labels()) == ["transpose", "dot_general", "dot_general"]


def test_frontend_edag_feeds_class_vector_replay():
    gt = T.edag_from_fn(polybench.TORCH_KERNELS["gemm"],
                        *[torch.ones(4, 4)] * 3)
    gr = R.edag_from_fn(rpoly.JAX_KERNELS["gemm"], *[jnp.ones((4, 4))] * 3)
    cls = (np.arange(gt.n_vertices) % 2).astype(np.int32)
    gt.set_mem_classes(cls)
    gr.set_mem_classes(cls)
    for alphas in ([3.0, 50.0], [50.0, 50.0]):
        two = T.simulate_reference_classes(gt, np.array(alphas), m=2)
        assert two == R.simulate_reference_classes(gr, np.array(alphas),
                                                   m=2)
    gt.set_mem_classes(None)
    gr.set_mem_classes(None)
    assert T.simulate_reference(gt, m=2, alpha=50.0) == \
        R.simulate_reference(gr, m=2, alpha=50.0)


# ------------------------------------------------------ frontend contract

def test_tracing_is_abstract_and_device_free():
    """``cpu`` and ``meta`` arguments give the same eDAG; nothing runs."""
    args = polybench.twin_inputs("syr2k", 7)
    fn = polybench.TORCH_KERNELS["syr2k"]
    g_cpu = T.edag_from_fn(fn, *[torch.tensor(a, dtype=torch.float32)
                                 for a in args])
    g_meta = T.edag_from_fn(fn, *map(meta, args))
    assert arrays(g_cpu) == arrays(g_meta)


def test_unhandled_higher_order_op_raises_by_name():
    from torch._higher_order_ops.while_loop import while_loop
    with pytest.raises(NotImplementedError, match="while_loop"):
        T.edag_from_fn(lambda i, x: while_loop(
            lambda i, x: i < 3, lambda i, x: (i + 1, x * 2.0), (i, x)),
            torch.tensor(0), torch.ones(3))


def test_in_place_graph_is_refused():
    from torch.fx.experimental.proxy_tensor import make_fx
    gm = make_fx(lambda x: x.clone().add_(1.0), pre_dispatch=True)(
        torch.ones(3))
    with pytest.raises(NotImplementedError, match="add_"):
        T.edag_from_graph(gm)


def test_in_place_program_is_functionalized():
    """``edag_from_fn`` captures a functional graph: a write through a view
    becomes a scatter its readers depend on."""
    def f(x):
        y = x.clone()
        y[0] = 1.0
        return y * 2.0
    g = T.edag_from_fn(f, torch.ones(4))
    g.trace_digest()
    labels = list(g.labels())
    assert labels[-1] == "mul"
    assert "scatter" in labels
    mul = len(labels) - 1
    preds = {labels[int(s)] for s, d in zip(g.src, g.dst) if d == mul}
    assert preds == {"scatter"}


# ------------------------------------------------------------- the twins

def twin_pair(name: str, size: dict):
    """(port eDAG, reference eDAG) of twin ``name`` traced from float32
    inputs of the given size."""
    if name == "cg":
        n, it = size["hpcg_n"], size["hpcg_iters"]
        b = hpcg.build_problem(n)
        return (T.edag_from_fn(lambda b: hpcg.cg_torch(b, n, it), meta(b)),
                R.edag_from_fn(lambda b: rhpcg.cg_jax(b, n, it), f32(b)))
    if name == "lulesh":
        ne, it = size["lulesh_ne"], size["lulesh_iters"]
        st = lulesh.initial_state(ne)
        step, jstep = lulesh.make_torch_step(ne, "meta"), \
            rlulesh.make_jax_step(ne)
        return (T.edag_from_fn(lambda *s: lulesh.run_steps(step, s, it),
                               *map(meta, st)),
                R.edag_from_fn(lambda *s: jax.lax.scan(
                    jstep, tuple(s), None, length=it), *map(f32, st)))
    args = polybench.twin_inputs(name, size["polybench_N"])
    return (T.edag_from_fn(polybench.TORCH_KERNELS[name], *map(meta, args)),
            R.edag_from_fn(rpoly.JAX_KERNELS[name], *map(f32, args)))


def named_difference(name: str, size: dict) -> dict:
    """Port label count minus the reference's, per label, for the twins
    whose decompositions differ.

    * trisolv: the reference's body indexes ``b[i]``, ``L[i]`` and
      ``L[i, i]`` with the traced step (bounds ``lt``/``add``/``select_n``,
      ``dynamic_slice``, ``squeeze``) and sets x with a ``scatter``; the
      port scans the rows with a one-hot ``where`` (``select_n``), made
      once by ``eye`` and ``diagonal``;
    * cg: the reference rolls and masks (``jnp.roll`` is a jitted call, an
      opaque ``jit`` vertex by §C 2; the masks are ``broadcast_in_dim``
      and ``scatter``; one ``mul`` per neighbour); the port slices a
      zero-padded grid (``pad``, 3 ``slice`` per neighbour) and stacks the
      history (``stack``); export drops the last iteration's dead ``p``
      update (``div``, ``mul``, ``add``);
    * lulesh: the reference's gathers normalise negative indices
      (``lt``/``add``/``select_n``, ``broadcast_in_dim``), ``jnp.repeat``
      is ``broadcast_in_dim``/``reshape``, ``gv[:, 0]`` is
      ``slice``/``squeeze``; the port has ``repeat_interleave``,
      ``select`` and one ``stack``."""
    if name == "trisolv":
        N = size["polybench_N"]
        return {"add": -5 * N, "broadcast_in_dim": -N, "diagonal": 1,
                "dynamic_slice": -3 * N, "eye": 1, "iota": -1,
                "lt": -5 * N, "scatter": -N, "select_n": -4 * N,
                "squeeze": -3 * N}
    if name == "cg":
        it = size["hpcg_iters"]
        return {"add": -1, "broadcast_in_dim": -134 * it, "div": -1,
                "jit": -26 * it, "mul": -(26 * it + 1), "pad": it,
                "scatter": -54 * it, "slice": 78 * it, "stack": 1}
    if name == "lulesh":
        it = size["lulesh_iters"]
        return {"add": -3 * it, "broadcast_in_dim": -4 * it,
                "lt": -3 * it, "repeat_interleave": it, "reshape": -2 * it,
                "select": it, "select_n": -3 * it, "slice": -it,
                "squeeze": -it, "stack": 1}
    return {}


def label_difference(port_labels, ref_labels) -> dict:
    cp, cr = Counter(port_labels), Counter(ref_labels)
    return {k: cp[k] - cr[k] for k in set(cp) | set(cr) if cp[k] != cr[k]}


SMALL = dict(polybench_N=8, hpcg_n=4, hpcg_iters=3, lulesh_ne=3,
             lulesh_iters=2)
TWINS = list(polybench.TORCH_KERNELS) + ["cg", "lulesh"]


def test_the_named_twins_agree_with_the_reference():
    assert set(MUST_AGREE) <= set(AGREE)


@pytest.mark.parametrize("name", TWINS)
def test_twin_edag_against_the_reference(name):
    gt, gr = twin_pair(name, SMALL)
    if name in AGREE:
        assert_same(gt, gr)
    else:
        assert label_difference(gt.labels(), gr.labels()) == \
            named_difference(name, SMALL)


@pytest.mark.parametrize("name", TWINS)
def test_twin_edags_at_paper_size_match_the_expected_file(name):
    """The reference's and the port's eDAGs at the paper's sizes, as the
    fixture recorded them; the agreeing twins are equal to the
    reference's, the others differ exactly as named."""
    size = EXPECTED["config"]["twins"]
    ref, port = EXPECTED["reference_twins"][name], \
        EXPECTED["port_twins"][name]
    if name in AGREE:
        for key in ("vertices", "edges", "labels", "digest", "cost_sum",
                    "nbytes_sum", "mem_vertices"):
            assert port[key] == ref[key], key
    else:
        assert label_difference(port["labels"], ref["labels"]) == \
            named_difference(name, size)
    if name in ("cg", "lulesh", "trisolv", "gemm"):
        gt, _ = twin_pair(name, size)
        got = arrays(gt)
        assert (got["n"], len(got["src"]), got["digest"], got["labels"]) == \
            (port["vertices"], port["edges"], port["digest"], port["labels"])
        assert float(np.sum(gt.cost)) == port["cost_sum"]
        assert float(np.sum(gt.nbytes)) == port["nbytes_sum"]


def as_reference(g):
    g.trace_digest()
    return R.EDag.from_arrays(g.cost, g.is_mem, g.nbytes, g.src, g.dst,
                              labels=list(g.labels()))


def report_row(rep) -> dict:
    return {k: np.asarray(v).tolist() for k, v in vars(rep).items()}


@pytest.mark.parametrize("dtype", POLICIES)
@pytest.mark.parametrize("name", TWINS)
def test_twin_analyses_bitwise_equal(name, dtype):
    gt, _ = twin_pair(name, SMALL)
    gr = as_reference(gt)
    assert report_row(T.report(gt)) == report_row(R.report(gr))
    for m, cs in ((2, 0), (4, 8)):
        lt = T.latency_sweep(gt, GRID_ALPHAS, m=m, compute_slots=cs,
                             replay_dtype=dtype)
        lr = R.latency_sweep(gr, GRID_ALPHAS, m=m, compute_slots=cs,
                             replay_dtype=dtype)
        assert lt.tobytes() == lr.tobytes()
    st = T.sweep_grid(gt, GRID_ALPHAS, ms=(2, 4, 8), compute_slots=(0, 8),
                      replay_dtype=dtype)
    sr = R.sweep_grid(gr, GRID_ALPHAS, ms=(2, 4, 8), compute_slots=(0, 8),
                      replay_dtype=dtype)
    assert st.shape == sr.shape and st.tobytes() == sr.tobytes()


@pytest.mark.parametrize("name", ["gemm", "trisolv", "lulesh", "cg"])
def test_twin_analyses_at_paper_size_match_the_expected_file(name):
    """The port's report and sweep grid on its paper-size twin eDAG equal
    the JAX package's on the same arrays, as the fixture recorded them."""
    gt, _ = twin_pair(name, EXPECTED["config"]["twins"])
    want = EXPECTED["port_twins"][name]
    grid = EXPECTED["config"]["grid"]
    assert json.loads(json.dumps(report_row(T.report(gt)))) == \
        want["report"]
    got = T.sweep_grid(gt, grid["alphas"], ms=grid["ms"],
                       compute_slots=grid["compute_slots"])
    assert got.tolist() == want["sweep_grid"]
