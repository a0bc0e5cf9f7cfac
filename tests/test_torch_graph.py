"""The port's eDAG (``repro_torch.core.graph``) against the JAX package's.

Both packages get identical arrays (the reference eDAG's, as numpy, through
``EDag.from_arrays``) or identical traces; every analysis must agree bit
for bit, on the CPU through the level kernel's plain version.
"""
import numpy as np
import pytest

from repro.core import EDag as REDag
from repro.core import metrics as rmet
from repro_torch.core import EDag as TEDag
from repro_torch.core import IndexOverflowError
from repro_torch.core import graph as tgraph
from repro_torch.core import metrics as tmet


@pytest.fixture(autouse=True)
def cpu_backend(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")
    for knob in ("EDAN_X64", "EDAN_REPLAY_DTYPE", "EDAN_BACKEND"):
        monkeypatch.delenv(knob, raising=False)


def _random_pair(seed: int, n: int = 60, p: float = 0.08):
    """The same random eDAG built through both packages' append APIs
    (scalar and block appends mixed)."""
    rng = np.random.default_rng(seed)
    cost = rng.integers(1, 6, n).astype(float)
    mem = rng.random(n) < 0.5
    nb = np.where(mem, 8.0, 0.0)
    edges = [(j, i) for i in range(n) for j in range(i) if rng.random() < p]
    out = []
    for cls in (REDag, TEDag):
        g = cls()
        half = n // 2
        for i in range(half):
            g.add_vertex(cost=cost[i], is_mem=bool(mem[i]), nbytes=nb[i],
                         label=f"v{i % 3}")
        g.add_vertex_block(cost[half:], mem[half:], nb[half:], label="blk")
        src = np.array([e[0] for e in edges], dtype=np.int64)
        dst = np.array([e[1] for e in edges], dtype=np.int64)
        g.add_edge_block(src[::2], dst[::2])
        for s, d in zip(src[1::2].tolist(), dst[1::2].tolist()):
            g.add_edge(s, d)
        g._finalize()
        out.append(g)
    return out


def _adopt(g: REDag) -> TEDag:
    return TEDag.from_arrays(g.cost, g.is_mem, g.nbytes, g.src, g.dst,
                             labels=list(g.labels()))


@pytest.mark.parametrize("seed", range(4))
def test_build_paths_and_digest(seed):
    r, t = _random_pair(seed)
    assert t.trace_digest() == r.trace_digest()
    assert _adopt(r).trace_digest() == r.trace_digest()
    for name in ("cost", "is_mem", "nbytes", "src", "dst", "level",
                 "succ_dst", "succ_indptr", "indeg"):
        assert np.array_equal(getattr(r, name), getattr(t, name)), name
    assert list(t.labels()) == list(r.labels())
    assert t.n_levels == r.n_levels
    assert (t.n_vertices, t.n_edges) == (r.n_vertices, r.n_edges)


@pytest.mark.parametrize("seed", range(4))
def test_finish_times_layers_critical_path(seed):
    r, _ = _random_pair(seed)
    t = _adopt(r)
    cost = np.random.default_rng(seed).standard_normal(r.n_vertices) * 3
    assert np.array_equal(r.finish_times(), t.finish_times())
    assert np.array_equal(r.finish_times(cost), t.finish_times(cost))
    assert r.t_inf() == t.t_inf() and r.t1() == t.t1()
    assert r.parallelism() == t.parallelism()
    S0, F0 = r.start_finish(cost)
    S1, F1 = t.start_finish(cost)
    assert np.array_equal(S0, S1) and np.array_equal(F0, F1)
    a, b = r.mem_layers(), t.mem_layers()
    assert (a.W, a.D) == (b.W, b.D)
    assert np.array_equal(a.level, b.level)
    assert np.array_equal(a.layer_sizes, b.layer_sizes)
    assert r.critical_path() == t.critical_path()
    assert r.critical_path(cost) == t.critical_path(cost)
    costs = np.random.default_rng(seed + 1).integers(1, 9, (3, r.n_vertices))
    assert np.array_equal(r.finish_times_batch(costs),
                          t.finish_times_batch(costs))
    assert np.array_equal(r.t_inf_batch(costs), t.t_inf_batch(costs))


@pytest.mark.parametrize("dtype", [None, "float32", "float64"])
@pytest.mark.parametrize("seed", range(3))
def test_t_inf_sweep_mem_scalar_rows(seed, dtype):
    r, _ = _random_pair(seed)
    t = _adopt(r)
    alphas = [50.0, 75.0, 0.1, 300.0, 1.0 / 3.0]
    for chunk in (None, 2):
        want = r.t_inf_sweep_mem(alphas, unit=1.0, chunk=chunk)
        got = t.t_inf_sweep_mem(alphas, unit=1.0, chunk=chunk,
                                replay_dtype=dtype)
        assert np.array_equal(want, got)
    assert np.array_equal(rmet.t_inf_sweep(r, alphas),
                          tmet.t_inf_sweep(t, alphas))
    assert np.array_equal(rmet.bandwidth_sweep(r, alphas),
                          tmet.bandwidth_sweep(t, alphas))


@pytest.mark.parametrize("seed", range(3))
def test_t_inf_sweep_mem_class_rows(seed):
    r, _ = _random_pair(seed)
    t = _adopt(r)
    classes = np.random.default_rng(seed).integers(0, 3, r.n_vertices)
    r.set_mem_classes(classes, names=["a", "b", "c"])
    t.set_mem_classes(classes, names=["a", "b", "c"])
    assert t.mem_class_digest() == r.mem_class_digest()
    assert t.n_mem_classes() == r.n_mem_classes()
    rows = np.array([[50.0, 100.0, 200.0], [75.0, 75.0, 75.0],
                     [0.1, 3.0, 12.5]])
    for dtype in (None, "float32"):
        assert np.array_equal(r.t_inf_sweep_mem(rows),
                              t.t_inf_sweep_mem(rows, replay_dtype=dtype))
    assert np.array_equal(rmet.cost_matrix(r, rows), tmet.cost_matrix(t, rows))
    assert np.array_equal(rmet.cost_vector(r, rows[0]),
                          tmet.cost_vector(t, rows[0]))
    with pytest.raises(ValueError, match="class"):
        t.t_inf_sweep_mem(rows[:, :2])


def test_empty_and_edgeless_graphs():
    t = TEDag()
    t._finalize()
    assert t.t_inf() == 0.0 and t.critical_path() == []
    assert np.array_equal(t.t_inf_sweep_mem([50.0]), np.zeros(1))
    r = REDag()
    for _ in range(3):
        r.add_vertex(cost=2.0, is_mem=True)
    r._finalize()
    t = _adopt(r)
    assert np.array_equal(r.finish_times(), t.finish_times())
    assert r.mem_layers().D == t.mem_layers().D


def test_adopted_graph_is_immutable_and_validated():
    r, _ = _random_pair(0)
    t = _adopt(r)
    with pytest.raises(ValueError, match="immutable"):
        t.add_vertex()
    with pytest.raises(ValueError, match="topological"):
        TEDag.from_arrays(np.ones(2), np.zeros(2, bool), np.zeros(2),
                          np.array([1]), np.array([0]))


def test_index_overflow_guard(monkeypatch):
    monkeypatch.setattr(tgraph, "_INDEX_LIMIT", 8)
    g = TEDag()
    g.add_vertex_block(1.0, False, 0.0, n=7)
    with pytest.raises(IndexOverflowError):
        g.add_vertex()
    with pytest.raises(IndexOverflowError):
        g.add_edge_block(np.zeros(8, dtype=np.int64), np.full(8, 6))


def test_edge_order_violation_raises():
    g = TEDag()
    g.add_vertex()
    g.add_vertex()
    with pytest.raises(ValueError, match="topological"):
        g.add_edge(1, 0)
    with pytest.raises(ValueError, match="topological"):
        g.add_edge_block([1], [1])
