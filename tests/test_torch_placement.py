"""The port's placement search (``repro_torch.core.placement``), object
sensitivity and the plan layer's suite helpers against the JAX package's,
on the CPU.

The cases of ``tests/test_placement.py`` (object recovery, class maps and
rows, oracle and greedy searches on seeded multi-object traces, the curve,
budget extremes, method selection, overlay restore, validation, lambda
ranking, anonymous and memory-free traces) and the ``SweepSpec`` /
``cap_rows`` cases of ``tests/test_plan.py``, each run through both
packages.  Every report field must be bit-for-bit equal to the JAX
package's, under the float64 and the float32 replay policy.
"""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.core.placement import MAX_ORACLE_OBJECTS as R_MAX
from repro_torch.core.placement import MAX_ORACLE_OBJECTS, PlacementObject

DTYPES = [None, "float32"]


@pytest.fixture(autouse=True)
def cpu_backend(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")
    for knob in ("EDAN_X64", "EDAN_REPLAY_DTYPE", "EDAN_BACKEND",
                 "EDAN_REPLAY_MEM_BUDGET"):
        monkeypatch.delenv(knob, raising=False)


def traced_objects(pkg, seed: int, n_obj: int = 3, n_ops: int = 20):
    """A random multi-object trace through ``pkg``'s own tracer: named
    arrays combined through random load/ALU/store chains."""
    rng = np.random.default_rng(seed)
    tr = pkg.Tracer()
    arrs = [tr.array(np.arange(4.0 * (i + 1)), f"obj{i}")
            for i in range(n_obj)]
    acc = tr.const(0.0)
    for _ in range(n_ops):
        a = arrs[rng.integers(n_obj)]
        v = a.load(int(rng.integers(len(a.arr))))
        if rng.random() < 0.5:
            acc = tr.alu("+", acc, v)
        if rng.random() < 0.4:
            b = arrs[rng.integers(n_obj)]
            b.store(int(rng.integers(len(b.arr))), acc)
    return tr.g, tr.object_sizes()


def traced_pair(seed, n_obj=3):
    (g, sizes), (t, tsizes) = (traced_objects(R, seed, n_obj),
                               traced_objects(T, seed, n_obj))
    g._finalize()
    t._finalize()
    assert sizes == tsizes
    for attr in ("is_mem", "nbytes", "src", "dst"):
        assert np.array_equal(getattr(t, attr), getattr(g, attr))
    assert list(t.labels()) == list(g.labels())
    return g, t, sizes


def same_objects(got, want) -> None:
    assert [o.name for o in got] == [o.name for o in want]
    for a, b in zip(got, want):
        assert np.array_equal(a.vertices, b.vertices)
        assert (a.nbytes, a.traffic, a.lam) == (b.nbytes, b.traffic, b.lam)


def same_report(got, want) -> None:
    for key in ("method", "alpha_local", "alpha_remote", "m",
                "compute_slots", "unit", "budget", "local", "makespan",
                "all_local", "all_remote", "curve_local", "marginal"):
        assert getattr(got, key) == getattr(want, key), key
    for key in ("budgets", "curve"):
        a, b = getattr(got, key), getattr(want, key)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
    same_objects(got.objects, want.objects)
    assert got.rows() == want.rows()


# --------------------------------------------------------- object recovery

@pytest.mark.parametrize("seed", range(3))
def test_objects_from_edag_names_sizes_traffic(seed):
    g, t, sizes = traced_pair(seed)
    same_objects(T.objects_from_edag(t, sizes=sizes),
                 R.objects_from_edag(g, sizes=sizes))
    same_objects(T.objects_from_edag(t), R.objects_from_edag(g))
    for o in T.objects_from_edag(t):
        assert o.nbytes == o.traffic


def test_object_class_map_and_rows():
    g, t, _ = traced_pair(1, n_obj=2)
    cls = T.object_class_map(t, T.objects_from_edag(t))
    want = R.object_class_map(g, R.objects_from_edag(g))
    assert cls.dtype == want.dtype and np.array_equal(cls, want)
    lists = [(), (0,), (0, 1)]
    assert np.array_equal(T.placement_rows(2, lists, 1.0, 9.0),
                          R.placement_rows(2, lists, 1.0, 9.0))
    assert np.array_equal(T.placement_rows(0, [()], 1.0, 9.0),
                          R.placement_rows(0, [()], 1.0, 9.0))


# ------------------------------------------------- searches, both packages

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed,n_obj,bfrac", [
    (0, 2, 0.0), (1, 3, 0.35), (2, 4, 0.7), (3, 4, 1.0), (4, 3, 0.7),
    (5, 2, 0.35)])
def test_oracle_matches_reference(seed, n_obj, bfrac, dtype):
    g, t, sizes = traced_pair(seed, n_obj)
    objs_r = R.objects_from_edag(g, sizes=sizes)
    budget = int(sum(o.nbytes for o in objs_r) * bfrac)
    want = R.search_placement(g, 1.0, 200.0, budget, objects=objs_r, m=2,
                              method="oracle")
    got = T.search_placement(t, 1.0, 200.0, budget,
                             objects=T.objects_from_edag(t, sizes=sizes),
                             m=2, method="oracle", replay_dtype=dtype)
    same_report(got, want)
    # a fresh reference replay of the chosen placement reproduces it
    names = [o.name for o in got.objects]
    row = T.placement_rows(len(names),
                           [[names.index(x) for x in got.local]],
                           1.0, 200.0)[0]
    t.set_mem_classes(T.object_class_map(t, got.objects), names=names)
    assert T.simulate_reference_classes(t, row, m=2) == got.makespan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed,n_obj,bfrac", [
    (10, 2, 0.35), (11, 3, 0.7), (12, 4, 0.35), (13, 5, 1.0), (14, 5, 0.0),
    (15, 3, 0.35)])
def test_greedy_matches_reference_within_bound(seed, n_obj, bfrac, dtype):
    g, t, sizes = traced_pair(seed, n_obj)
    objs = T.objects_from_edag(t, sizes=sizes)
    budget = int(sum(o.nbytes for o in objs) * bfrac)
    greedy = T.search_placement(t, 1.0, 200.0, budget, objects=objs, m=2,
                                method="greedy", replay_dtype=dtype)
    same_report(greedy, R.search_placement(
        g, 1.0, 200.0, budget, objects=R.objects_from_edag(g, sizes=sizes),
        m=2, method="greedy"))
    oracle = T.search_placement(t, 1.0, 200.0, budget, objects=objs, m=2,
                                method="oracle", replay_dtype=dtype)
    assert oracle.makespan <= greedy.makespan <= greedy.all_remote
    o_at = dict(zip(oracle.budgets.tolist(), oracle.curve.tolist()))
    for b, mk in zip(greedy.budgets.tolist(), greedy.curve.tolist()):
        if b in o_at:
            assert o_at[b] <= mk <= greedy.all_remote


@pytest.mark.parametrize("method", ["oracle", "greedy"])
def test_curve_monotone_and_endpoints(method):
    g, t, sizes = traced_pair(7, n_obj=4)
    total = sum(o.nbytes for o in T.objects_from_edag(t, sizes=sizes))
    rep = T.search_placement(t, 1.0, 200.0, total,
                             objects=T.objects_from_edag(t, sizes=sizes),
                             m=3, compute_slots=2, method=method)
    same_report(rep, R.search_placement(
        g, 1.0, 200.0, total, objects=R.objects_from_edag(g, sizes=sizes),
        m=3, compute_slots=2, method=method))
    assert (np.diff(rep.curve) <= 0).all()
    assert rep.curve[0] == rep.all_remote
    assert rep.curve[-1] == min(rep.all_local, rep.all_remote)
    assert all(v >= 0 for v in rep.marginal.values())


def test_zero_budget_all_remote_and_big_budget_all_local():
    g, t, sizes = traced_pair(11, n_obj=3)
    for budget in (0, 10 ** 9):
        rep = T.search_placement(t, 1.0, 200.0, budget,
                                 objects=T.objects_from_edag(t, sizes=sizes))
        same_report(rep, R.search_placement(
            g, 1.0, 200.0, budget,
            objects=R.objects_from_edag(g, sizes=sizes)))
    assert rep.makespan == rep.all_local


def test_auto_method_switches_on_object_count():
    _, t, sizes = traced_pair(13, n_obj=3)
    objs = T.objects_from_edag(t, sizes=sizes)
    assert T.search_placement(t, 1.0, 9.0, 0, objects=objs).method == \
        "oracle"
    assert T.search_placement(t, 1.0, 9.0, 0, objects=objs,
                              max_oracle_objects=2).method == "greedy"
    with pytest.raises(ValueError, match="oracle"):
        T.search_placement(t, 1.0, 9.0, 0, objects=objs, method="oracle",
                           max_oracle_objects=2)
    assert MAX_ORACLE_OBJECTS == R_MAX == 8


def test_overlay_saved_and_restored():
    _, t, _ = traced_pair(17, n_obj=2)
    mine = np.zeros(t.n_vertices, dtype=np.int32)
    mine[t.n_vertices // 2:] = 1
    t.set_mem_classes(mine, names=["lo", "hi"])
    T.search_placement(t, 1.0, 200.0, 0)
    assert np.array_equal(t.mem_classes, mine)
    assert t.mem_class_names == ["lo", "hi"]
    t.set_mem_classes(None)
    T.search_placement(t, 1.0, 200.0, 0)
    assert t.mem_classes is None


@pytest.mark.parametrize("args,kw,match", [
    ((0.0, 200.0, 0), {}, "positive"), ((1.0, np.inf, 0), {}, "positive"),
    ((1.0, 200.0, -1), {}, "budget"),
    ((1.0, 200.0, 0), dict(method="magic"), "method"),
    ((1.0, 200.0, 0), dict(budgets=[-5, 0]), "budgets")])
def test_validation(args, kw, match):
    g, t, _ = traced_pair(19, n_obj=2)
    for pkg, graph in ((R, g), (T, t)):
        with pytest.raises(ValueError, match=match):
            pkg.search_placement(graph, *args, **kw)


def test_lambda_ranking_fills_objects():
    reps = []
    for pkg in (R, T):
        tr = pkg.Tracer()
        hot = tr.array(np.zeros(4), "hot")
        cold = tr.array(np.zeros(4), "cold")
        acc = tr.const(0.0)
        for _ in range(10):
            acc = tr.alu("+", acc, hot.load(0))
        acc = tr.alu("+", acc, cold.load(0))
        objs = pkg.objects_from_edag(tr.g, sizes=tr.object_sizes())
        reps.append(pkg.search_placement(tr.g, 1.0, 200.0, 4 * 8,
                                         objects=objs, m=2,
                                         method="greedy"))
    same_report(reps[1], reps[0])
    by_name = {o.name: o for o in reps[1].objects}
    assert by_name["hot"].lam > by_name["cold"].lam
    assert reps[1].local == ("hot",)


def test_object_sensitivity_matches_reference():
    g, t, sizes = traced_pair(23, n_obj=4)
    objs = {o.name: o.vertices for o in T.objects_from_edag(t)}
    for m in (1, 2, 5):
        got = T.object_sensitivity(t, objs, m=m, alpha=3.0)
        want = R.object_sensitivity(g, objs, m=m, alpha=3.0)
        assert {k: v.row() for k, v in got.items()} == \
            {k: v.row() for k, v in want.items()}


def test_anonymous_and_memory_free_traces():
    for pkg in (R, T):
        g = pkg.EDag()
        g.add_vertex(is_mem=True, nbytes=8.0)
        g.add_vertex(is_mem=False)
        (o,) = pkg.objects_from_edag(g)
        assert o.name == "<anon>" and o.n_accesses == 1
        rep = pkg.search_placement(g, 1.0, 200.0, 8)
        assert rep.local == ("<anon>",) and rep.makespan == rep.all_local
        h = pkg.EDag()
        h.add_vertex(is_mem=False)
        h.add_vertex(is_mem=False)
        h.add_edge(0, 1)
        assert pkg.objects_from_edag(h) == []
        rep = pkg.search_placement(h, 1.0, 9.0, 0)
        assert rep.local == () and rep.marginal == {}
        assert rep.makespan == rep.all_local == rep.all_remote == 2.0
        assert rep.curve.tolist() == [rep.makespan]


def test_placement_object_dataclass():
    o = PlacementObject(name="x", vertices=np.array([1, 2, 3]),
                        nbytes=24, traffic=24)
    assert o.n_accesses == 3 and o.lam == 0.0


# ------------------------------------------------------------- plan layer

@pytest.mark.parametrize("alphas,ms,css", [
    ([3.0, 1.0, 3.0, 2.0], [2, 4], [0, 1]),
    ([[3.0, 1.0], [1.0, 2.0], [3.0, 1.0]], [4], [0]),
    ([2.0, -1.0, 2.0], [1, 3], [2]),
    ([], [2], [0, 8]),
    (5.0, [8, 2], [0])])
def test_sweepspec_suite_fields_match_reference(alphas, ms, css):
    got = T.SweepSpec.make(alphas, ms=ms, compute_slots=css)
    want = R.SweepSpec.make(alphas, ms=ms, compute_slots=css)
    assert (got.n_points, got.n_uniq, got.n_classes, got.pairs) == \
        (want.n_points, want.n_uniq, want.n_classes, want.pairs)
    assert np.array_equal(got.uniq, want.uniq)
    assert got.pairs == [(m, c) for m in got.ms for c in got.css]


@pytest.mark.parametrize("budget", [1, 32 * 100, 4096, 512 * 1024 * 1024,
                                    None])
def test_cap_rows_and_points_chunk_match_reference(budget):
    got = T.ExecPolicy.resolve(mem_budget=budget)
    want = R.ExecPolicy.resolve(mem_budget=budget)
    for k in (1, 10, 13, 78, 10 ** 9):
        assert got.cap_rows(k) == want.cap_rows(k)
        for n in (1, 10, 554380, 3326280):
            assert got.points_chunk(n, k) == want.points_chunk(n, k)
    assert T.ExecPolicy.resolve(mem_budget=32 * 100).cap_rows(10) == 10
