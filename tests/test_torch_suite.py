"""The port's union suites (``repro_torch.core.suite``) against the JAX
package's, on the CPU.

The cases of ``tests/test_suite.py`` that need no schedule cache on disk,
each run through both packages: block-diagonal structure, bad inputs,
mutated members, seeded random suites over mixed machine grids with
tie-heavy alphas, empty and singleton suites, unsorted and duplicate
alphas, degenerate machines, the budget invariant, the member-memo tier,
tie-heavy fallback, the fallback's point count, ``suite_t_inf_sweep``, ``suite_grid_report``,
class-vector grids, ``suite_axis_latency_grid``, ``_member_groups`` and
heterogeneous grouping, and the disk-cache cases (cold then warm suites,
and suites and single traces warming each other through the persistent
schedule cache).  Every result must be bit-for-bit equal to the JAX
package's, under the float64 and the float32 replay policy.
"""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.core.suite import _member_groups as r_groups
from repro_torch.core import backend as tbk
from repro_torch.core import scheduler as tsched
from repro_torch.core import suite as tsuite
from repro_torch.core.plan import ExecPolicy as TPolicy

DTYPES = [None, "float32"]
TIE_PALETTE = [0.5, 1.0, 2.0, 3.0, 50.0, 200.0, 333.25]


@pytest.fixture(autouse=True)
def cpu_backend(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")
    for knob in ("EDAN_X64", "EDAN_REPLAY_DTYPE", "EDAN_BACKEND",
                 "EDAN_REPLAY_MEM_BUDGET"):
        monkeypatch.delenv(knob, raising=False)


def rand_pair(seed: int, n: int, p_edge: float = 0.12, p_mem: float = 0.5):
    """The same random DAG in both packages."""
    rng = np.random.default_rng(seed)
    g = R.EDag()
    for i in range(n):
        g.add_vertex(is_mem=bool(rng.random() < p_mem), nbytes=8.0)
        for j in range(i):
            if rng.random() < p_edge:
                g.add_edge(j, i)
    g._finalize()
    t = T.EDag()
    if n:
        t.add_vertex_block(g.cost, g.is_mem, g.nbytes, n=n)
        t.add_edge_block(g.src, g.dst)
    t._finalize()
    return g, t


def suites(specs, names=None, classes=None):
    """(reference suite, port suite) over ``(seed, n[, p_edge])`` specs;
    ``classes`` seeds a per-member class overlay of that many classes."""
    pairs = [rand_pair(*s) for s in specs]
    if classes:
        for k, (g, t) in enumerate(pairs):
            rng = np.random.default_rng(100 + k)
            c = rng.integers(0, classes, size=g.n_vertices, dtype=np.int32)
            g.set_mem_classes(c)
            t.set_mem_classes(c)
    return (R.EDagSuite([p[0] for p in pairs], names=names),
            T.EDagSuite([p[1] for p in pairs], names=names))


def bits(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


# ---------------------------------------------------------------- the union

def test_concat_edags_block_diagonal_structure():
    rs, ts = suites([(0, 30), (1, 0), (2, 12)], names=["a", "b", "c"])
    ru, tu = rs.union, ts.union
    for attr in ("cost", "is_mem", "nbytes", "src", "dst", "level"):
        assert np.array_equal(getattr(tu, attr), getattr(ru, attr)), attr
    assert list(tu.labels()) == list(ru.labels())
    assert bits(ts.offsets, rs.offsets) and bits(ts.trace_id, rs.trace_id)
    tid = ts.trace_id
    assert np.array_equal(tid[tu.src], tid[tu.dst])
    assert tu.t1() == ru.t1()
    for k, g in enumerate(ts.members):
        off = ts.offsets[k]
        assert np.array_equal(tu.level[off:off + g.n_vertices], g.level)
    assert tu.subgraph_stats() == ru.subgraph_stats()
    assert T.concat_edags([]).n_vertices == R.concat_edags([]).n_vertices


@pytest.mark.parametrize("pkg", [R, T])
def test_suite_rejects_bad_inputs(pkg):
    g = pkg.EDag()
    g.add_vertex(is_mem=True)
    with pytest.raises(TypeError):
        pkg.EDagSuite([g, "not an edag"])
    with pytest.raises(ValueError):
        pkg.EDagSuite([g], names=["a", "b"])


def test_suite_refuses_mutated_members():
    _, ts = suites([(0, 10), (1, 8)])
    g0 = ts.members[0]
    ts.union
    # members built through the append path stay mutable
    g0.add_vertex(is_mem=True)
    for op in (lambda: ts.union,
               lambda: ts.segment_sum(np.zeros(ts.n_vertices)),
               lambda: T.suite_sweep_grid(ts, [50.0]),
               lambda: T.suite_t_inf_sweep(ts, [50.0])):
        with pytest.raises(ValueError, match="mutated"):
            op()
    _, ts2 = suites([(2, 10), (3, 8)])
    g3 = ts2.members[1]
    g3.add_edge(0, g3.n_vertices - 1)
    with pytest.raises(ValueError, match="mutated"):
        T.suite_sweep_grid(ts2, [50.0])


# ------------------------------------------------- seeded grid identity

def _random_case(seed: int):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(0, 4))
    specs = [(seed * 7 + i, int(rng.integers(0, 45))) for i in range(k)]
    ms = sorted({int(rng.integers(1, 6)), int(rng.integers(1, 6))})
    css = sorted({int(rng.integers(0, 5)), int(rng.integers(0, 5))})
    alphas = rng.choice(TIE_PALETTE, size=3, replace=False)
    return specs, ms, css, alphas


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(6))
def test_suite_grid_equals_reference_suite_and_stacked_singles(seed, dtype):
    specs, ms, css, alphas = _random_case(seed)
    rs, ts = suites(specs)
    want = R.suite_sweep_grid(rs, alphas, ms=ms, compute_slots=css)
    got = T.suite_sweep_grid(ts, alphas, ms=ms, compute_slots=css,
                             replay_dtype=dtype)
    assert bits(got, want)
    for k, g in enumerate(ts.members):
        assert bits(got[k], T.sweep_grid(g, alphas, ms=ms,
                                         compute_slots=css))


def test_empty_and_singleton_suites():
    alphas = [50.0, 200.0]
    for pkg in (R, T):
        empty = pkg.EDagSuite([])
        assert pkg.suite_sweep_grid(empty, alphas, ms=[2, 4]).shape == \
            (0, 2, 2, 1)
        assert pkg.suite_t_inf_sweep(empty, alphas).shape == (0, 2)
        hollow = pkg.EDagSuite([pkg.EDag(), pkg.EDag()])
        assert np.array_equal(pkg.suite_sweep_grid(hollow, alphas),
                              np.zeros((2, 2, 1, 1)))
    rs, ts = suites([(7, 35)])
    assert bits(T.suite_sweep_grid(ts, alphas, ms=[2, 4],
                                   compute_slots=[0, 3]),
                R.suite_sweep_grid(rs, alphas, ms=[2, 4],
                                   compute_slots=[0, 3]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_suite_alphas_unsorted_and_duplicates_return_caller_order(dtype):
    rs, ts = suites([(3, 40), (4, 20)])
    alphas = [200.0, 50.0, 200.0, 0.5, 50.0]
    assert bits(T.suite_sweep_grid(ts, alphas, ms=[2], compute_slots=[1],
                                   replay_dtype=dtype),
                R.suite_sweep_grid(rs, alphas, ms=[2], compute_slots=[1]))
    assert bits(T.suite_latency_sweep(ts, alphas, m=2, compute_slots=1,
                                      replay_dtype=dtype),
                R.suite_latency_sweep(rs, alphas, m=2, compute_slots=1))


@pytest.mark.parametrize("alphas", [[0.0, 50.0], [-1.0, 2.0],
                                    [np.inf, 50.0]])
def test_suite_degenerate_machine_models_keep_reference_semantics(alphas):
    rs, ts = suites([(5, 12), (6, 8)])
    assert bits(T.suite_sweep_grid(ts, alphas, ms=[2]),
                R.suite_sweep_grid(rs, alphas, ms=[2]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_suite_memory_budget_invariant(dtype):
    rs, ts = suites([(21, 45), (22, 35)])
    alphas = np.linspace(40.0, 300.0, 14)
    want = R.suite_sweep_grid(rs, alphas, ms=[1, 4], compute_slots=[0, 3])
    tbk.reset_stats()
    full = T.suite_sweep_grid(ts, alphas, ms=[1, 4], compute_slots=[0, 3],
                              replay_dtype=dtype)
    chunks = tbk.stats["chunks"]
    tiny = T.suite_sweep_grid(ts, alphas, ms=[1, 4], compute_slots=[0, 3],
                              mem_budget=1, replay_dtype=dtype)
    assert tbk.stats["chunks"] - chunks > chunks
    assert bits(full, want) and bits(tiny, want)


# --------------------------------------------------------- schedule reuse

def test_suite_warms_member_memo_and_memoizes_union_plans():
    """The member memo is the suite's reuse tier: a cold suite records one
    schedule per (member, m, cs) and warms each member's memo, so
    single-trace sweeps of the same members record nothing; a second suite
    over the same members hits those memos, and a repeat on one suite
    object hits its union-plan memo."""
    rs, ts = suites([(61, 40), (62, 25)])
    alphas = [50.0, 100.0, 200.0]
    tsched.stats.reset()
    grid = T.suite_sweep_grid(ts, alphas, ms=[2, 4], compute_slots=[1])
    assert tsched.stats["record_runs"] == 2 * 2
    assert bits(grid, R.suite_sweep_grid(rs, alphas, ms=[2, 4],
                                         compute_slots=[1]))
    tsched.stats.reset()
    for k, g in enumerate(ts.members):
        for j, m in enumerate([2, 4]):
            assert bits(T.latency_sweep(g, alphas, m=m, compute_slots=1),
                        grid[k, :, j, 0])
    assert tsched.stats["record_runs"] == 0
    assert tsched.stats["memory_hits"] == 2 * 2
    tsched.stats.reset()
    again = T.EDagSuite(ts.members)
    assert bits(T.suite_sweep_grid(again, alphas, ms=[2, 4],
                                   compute_slots=[1]), grid)
    assert tsched.stats["record_runs"] == 0
    assert tsched.stats["memory_hits"] == 2 * 2
    tsched.stats.reset()
    built = tsuite.stats["plans_built"]
    assert bits(T.suite_sweep_grid(again, alphas, ms=[2, 4],
                                   compute_slots=[1]), grid)
    assert tsched.stats["memory_hits"] == 0
    assert tsuite.stats["plans_built"] == built


@pytest.fixture
def cache_env(tmp_path, monkeypatch):
    """Redirect the schedule cache to a private tmp dir, no size floor."""
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", str(tmp_path))
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MIN", "0")
    tsched.stats.reset()
    return tmp_path


def test_suite_use_cache_false_records_and_keeps_nothing(cache_env):
    rs, ts = suites([(14, 30), (15, 25)])
    alphas = [50.0, 200.0]
    tsched.stats.reset()
    got = T.suite_sweep_grid(ts, alphas, ms=[2], use_cache=False)
    assert tsched.stats["record_runs"] == 2
    assert tsched.stats["stores"] == 0
    assert list(cache_env.iterdir()) == []
    assert len(ts._suite_plans) == 0
    assert all(len(g._replay_plans) == 0 for g in ts.members)
    assert bits(got, R.suite_sweep_grid(rs, alphas, ms=[2],
                                        use_cache=False))


@pytest.mark.parametrize("dtype", DTYPES)
def test_suite_cache_cold_then_warm(cache_env, dtype):
    """A cold suite records one schedule per (member, m, cs) and stores
    each under its member's trace digest; a warm suite (fresh objects, the
    same directory) records none and gives the same bits; a third run on
    the same suite object hits its union-plan memo.  The reference's
    suite, sharing the directory, is warm too."""
    alphas = [50.0, 100.0, 200.0]
    ms, css = [2, 4], [0, 2]
    specs = [(0, 50), (1, 30), (2, 40)]
    n_blocks = len(specs) * len(ms) * len(css)
    _, ts1 = suites(specs)
    cold = T.suite_sweep_grid(ts1, alphas, ms=ms, compute_slots=css,
                              replay_dtype=dtype)
    assert tsched.stats["record_runs"] == n_blocks
    assert tsched.stats["stores"] == n_blocks
    tsched.stats.reset()
    rs2, ts2 = suites(specs)
    warm = T.suite_sweep_grid(ts2, alphas, ms=ms, compute_slots=css,
                              replay_dtype=dtype)
    assert tsched.stats["record_runs"] == 0
    assert tsched.stats["disk_hits"] == n_blocks
    assert bits(cold, warm)
    tsched.stats.reset()
    memo = T.suite_sweep_grid(ts2, alphas, ms=ms, compute_slots=css,
                              replay_dtype=dtype)
    assert tsched.stats["record_runs"] == 0
    assert tsched.stats["disk_hits"] == 0
    assert bits(memo, warm)
    R.schedule_cache.reset_stats()
    assert bits(R.suite_sweep_grid(rs2, alphas, ms=ms, compute_slots=css),
                warm)
    assert R.schedule_cache.stats["record_runs"] == 0
    assert R.schedule_cache.stats["disk_hits"] == n_blocks


def test_suite_reuses_single_trace_schedules_and_vice_versa(cache_env):
    """The suite shares the member-digest-keyed entries with the
    single-trace engine in both directions."""
    alphas = [50.0, 100.0, 200.0]
    _, t9 = rand_pair(9, 60)
    single = T.latency_sweep(t9, alphas, m=3, compute_slots=2)
    tsched.stats.reset()
    rs, ts = suites([(9, 60), (10, 20)])
    got = T.suite_sweep_grid(ts, alphas, ms=[3], compute_slots=[2])
    assert tsched.stats["record_runs"] == 1          # only the new member
    assert bits(got[0, :, 0, 0], single)
    assert bits(got, R.suite_sweep_grid(rs, alphas, ms=[3],
                                        compute_slots=[2]))
    tsched.stats.reset()
    _, fresh = rand_pair(10, 20)                     # the suite warmed it
    T.latency_sweep(fresh, alphas, m=3, compute_slots=2)
    assert tsched.stats["record_runs"] == 0
    assert tsched.stats["disk_hits"] == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_suite_tie_heavy_fallback_stays_exact(dtype):
    """A memoized union plan recorded at a benign alpha must not certify
    tie-heavy points it cannot order: those fall back per member, and the
    result stays equal to the reference's."""
    rs, ts = suites([(31, 70), (32, 55)])
    T.suite_sweep_grid(ts, [50.0, 100.0, 200.0], ms=[2], compute_slots=[1],
                       replay_dtype=dtype)
    tie = [0.5, 1.0, 2.0, 3.0]
    fb = tsuite.stats["fallback_points"]
    got = T.suite_sweep_grid(ts, tie, ms=[2], compute_slots=[1],
                             replay_dtype=dtype)
    assert tsuite.stats["fallback_points"] > fb
    for k, g in enumerate(rs.members):
        want = [R.simulate_reference(g, m=2, alpha=a, compute_slots=1)
                for a in tie]
        assert bits(got[k, :, 0, 0], np.array(want))


def _fallback_case(case: str):
    """(suites, [(alphas, ms, compute_slots), ...]) run in order on one
    suite: the tie-heavy points after a benign warm-up, a class-vector
    grid, and a seeded random suite."""
    if case == "tie":
        return suites([(31, 70), (32, 55)]), [
            ([50.0, 100.0, 200.0], [2], [1]), ([0.5, 1.0, 2.0, 3.0], [2],
                                               [1])]
    if case == "classes":
        rows = np.array([[40.0, 300.0], [300.0, 300.0], [120.0, 60.0],
                         [1.0, 1.0]])
        return suites([(61, 35), (62, 20), (63, 0)], classes=2), [
            (rows, [1, 3], [0, 2])]
    specs, ms, css, alphas = _random_case(3)
    return suites(specs), [(alphas, ms, css)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["tie", "classes", "random"])
def test_suite_fallback_points_match_reference(case, dtype, monkeypatch):
    """The port's per-member fallback answers exactly the points the
    reference's does, so a count on the card that differs from the
    reference's shows a union replay the port got wrong."""
    import repro.core.suite as rsuite
    ref = []
    orig = rsuite.simulate_batch

    def counted(g, alphas, *args, **kw):
        ref.append(len(alphas))
        return orig(g, alphas, *args, **kw)

    monkeypatch.setattr(rsuite, "simulate_batch", counted)
    (rs, ts), runs = _fallback_case(case)
    fb = tsuite.stats["fallback_points"]
    for alphas, ms, css in runs:
        want = R.suite_sweep_grid(rs, alphas, ms=ms, compute_slots=css)
        got = T.suite_sweep_grid(ts, alphas, ms=ms, compute_slots=css,
                                 replay_dtype=dtype)
        assert bits(got, want)
    assert tsuite.stats["fallback_points"] - fb == sum(ref)
    if case == "tie":
        assert sum(ref) > 0


# ------------------------------------------------------------ analytic side

@pytest.mark.parametrize("dtype", DTYPES)
def test_suite_t_inf_sweep_matches_reference_and_members(dtype):
    rs, ts = suites([(41, 40), (42, 0), (43, 55)])
    alphas = np.linspace(10.0, 400.0, 23)
    got = T.suite_t_inf_sweep(ts, alphas, replay_dtype=dtype)
    assert bits(got, R.suite_t_inf_sweep(rs, alphas))
    for k, g in enumerate(ts.members):
        assert bits(got[k], T.t_inf_sweep(g, alphas))


@pytest.mark.parametrize("dtype", DTYPES)
def test_suite_grid_report_matches_reference(dtype):
    rs, ts = suites([(51, 45), (52, 30)], names=["left", "right"])
    alphas = [50.0, 125.0, 300.0]
    ms, css = [1, 2, 4], [0, 2]
    want = R.suite_grid_report(rs, alphas, ms=ms, compute_slots=css,
                               simulate_points=True)
    got = T.suite_grid_report(ts, alphas, ms=ms, compute_slots=css,
                              simulate_points=True, replay_dtype=dtype)
    assert got.keys() == want.keys() and got["names"] == ["left", "right"]
    for key in want:
        if key != "names":
            assert bits(got[key], want[key]), key
    r1 = T.grid_report(ts.members[1], alphas, ms=ms, compute_slots=css,
                       simulate_points=True)
    assert bits(got["simulated"][1], r1["simulated"])
    assert bits(got["t_upper"][1], r1["t_upper"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_suite_class_vector_grid_matches_reference(dtype):
    rs, ts = suites([(61, 35), (62, 20), (63, 0)], classes=2)
    rows = np.array([[40.0, 300.0], [300.0, 300.0], [120.0, 60.0]])
    ms, css = [1, 3], [0, 2]
    got = T.suite_sweep_grid(ts, rows, ms=ms, compute_slots=css,
                             replay_dtype=dtype)
    assert bits(got, R.suite_sweep_grid(rs, rows, ms=ms, compute_slots=css))
    for k, g in enumerate(ts.members):
        assert bits(got[k], T.sweep_grid(g, rows, ms=ms, compute_slots=css))
    assert bits(T.suite_t_inf_sweep(ts, rows, replay_dtype=dtype),
                R.suite_t_inf_sweep(rs, rows))


def test_suite_class_grid_honors_env_mem_budget(monkeypatch):
    """Class grids build union plans (one per distinct m) and take the
    ``$EDAN_REPLAY_MEM_BUDGET`` chunk accounting: a tiny budget multiplies
    the replay dispatches and changes no bit."""
    rs, ts = suites([(71, 40), (72, 30)], classes=2)
    rows = np.array([[40.0, 300.0], [120.0, 60.0],
                     [80.0, 200.0], [300.0, 45.0]])
    ms, css = [2, 4], [0]
    built = []
    orig = tsuite._build_suite_plan

    def spy(*a, **kw):
        built.append(kw.get("n_classes"))
        return orig(*a, **kw)

    monkeypatch.setattr(tsuite, "_build_suite_plan", spy)
    tbk.reset_stats()
    full = T.suite_sweep_grid(ts, rows, ms=ms, compute_slots=css)
    full_chunks = tbk.stats["chunks"]
    assert built == [2, 2]
    monkeypatch.setenv("EDAN_REPLAY_MEM_BUDGET", "1")
    tbk.reset_stats()
    tiny = T.suite_sweep_grid(ts, rows, ms=ms, compute_slots=css)
    assert tbk.stats["chunks"] > full_chunks
    want = R.suite_sweep_grid(rs, rows, ms=ms, compute_slots=css)
    assert bits(full, want) and bits(tiny, want)


def _axes(pkg, m0, scale):
    return {
        "model": pkg.AxisSensitivity(
            axis="model", W=64 * scale, D=8, bytes=2.0 ** 30,
            lam=pkg.lambda_abs(64 * scale, 8, m0),
            lam_seconds=pkg.lambda_abs(64 * scale, 8, m0) * 1e-6),
        "pod": pkg.AxisSensitivity(
            axis="pod", W=16, D=4 * scale, bytes=2.0 ** 28,
            lam=pkg.lambda_abs(16, 4 * scale, m0),
            lam_seconds=pkg.lambda_abs(16, 4 * scale, m0) * 1e-5),
    }


@pytest.mark.parametrize("ms", [[2, 4, 8], [1], [3, 3, 16]])
def test_suite_axis_latency_grid_matches_reference(ms):
    from repro.core import sensitivity as rsens
    from repro_torch.core import sensitivity as tsens
    secs = {"step_a": 1e-3, "step_b": 2e-3}
    alphas = [1e-6, 5e-6, 10e-6]
    got = T.suite_axis_latency_grid(
        {"step_a": _axes(T, 4, 1), "step_b": _axes(T, 4, 2)}, alphas, ms,
        secs)
    want = R.suite_axis_latency_grid(
        {"step_a": _axes(R, 4, 1), "step_b": _axes(R, 4, 2)}, alphas, ms,
        secs)
    assert got.keys() == want.keys()
    for step in want:
        assert got[step].keys() == want[step].keys()
        for axis in want[step]:
            for key in ("alphas", "ms", "lam", "lam_seconds", "Lam"):
                assert bits(got[step][axis][key], want[step][axis][key])
        one = T.axis_latency_grid(_axes(T, 4, 1), alphas, ms, secs["step_a"])
        assert bits(one["pod"]["Lam"], got["step_a"]["pod"]["Lam"])
    sweep_t = T.axis_latency_sweep(_axes(T, 4, 2), alphas, 2e-3)
    sweep_r = R.axis_latency_sweep(_axes(R, 4, 2), alphas, 2e-3)
    for axis in sweep_r:
        for key in sweep_r[axis]:
            assert bits(sweep_t[axis][key], sweep_r[axis][key])
    assert tsens.total_step_sensitivity(_axes(T, ms[0], 1), 1e-3) == \
        rsens.total_step_sensitivity(_axes(R, ms[0], 1), 1e-3)
    assert T.suite_axis_latency_grid({}, alphas, ms, {}) == {}
    assert T.suite_axis_latency_grid({"s": {}}, alphas, ms,
                                     {"s": 1e-3}) == {"s": {}}


# --------------------------------------------- heterogeneous-suite chunking

@pytest.mark.parametrize("budget", [24 * 8 * 300 * 2, 32 * 8 * 600 * 2,
                                    1 << 40, 1])
def test_member_groups_match_reference(budget):
    from repro.core.plan import ExecPolicy as RPolicy
    rs, ts = suites([(40, 20), (41, 600, 0.02), (42, 25), (43, 30)])
    got = tsuite._member_groups(ts, 2, 8, TPolicy.resolve(mem_budget=budget))
    want = r_groups(rs, 2, 8, RPolicy.resolve(mem_budget=budget))
    assert got == want
    assert sorted(i for grp in got for i in grp) == [0, 1, 2, 3]
    assert TPolicy.resolve(mem_budget=budget).cap_rows(8) == \
        RPolicy.resolve(mem_budget=budget).cap_rows(8)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("budget", [None, 24 * 5 * 200 * 4, 1])
def test_heterogeneous_suite_grid_bit_identical_under_grouping(budget,
                                                               dtype):
    rs, ts = suites([(50, 20), (51, 400, 0.03), (52, 15)])
    alphas = [50.0, 100.0, 150.0, 200.0, 300.0]
    ms, css = [2, 4], [0, 2]
    want = R.suite_sweep_grid(rs, alphas, ms=ms, compute_slots=css,
                              mem_budget=budget)
    got = T.suite_sweep_grid(ts, alphas, ms=ms, compute_slots=css,
                             mem_budget=budget, replay_dtype=dtype)
    assert bits(got, want)


def test_heterogeneous_grouping_under_the_float32_certificate():
    """Grouped replay through the float32 certificate, clean and dirty
    alphas mixed: dirty columns are demoted to the float64 pass and every
    entry still equals the reference's."""
    rs, ts = suites([(60, 18), (61, 300, 0.03), (62, 22)])
    alphas = [50.0, 0.1, 125.0, 1.0 / 3.0, 300.0]
    ms, css = [2, 4], [0, 2]
    budget = 24 * len(alphas) * 150 * len(ms) * len(css)
    want = R.suite_sweep_grid(rs, alphas, ms=ms, compute_slots=css,
                              mem_budget=budget, use_cache=False)
    tbk.reset_stats()
    got = T.suite_sweep_grid(ts, alphas, ms=ms, compute_slots=css,
                             mem_budget=budget, use_cache=False,
                             replay_dtype="float32")
    assert bits(got, want)
    assert tbk.stats["certified_columns"] > 0
    assert tbk.stats["demoted_columns"] > 0


# ------------------------------------------------------- the block plan

@pytest.mark.parametrize("classes", [None, 3])
def test_union_plan_blocks_and_kernel_plan(classes):
    """The union replay plan is block-diagonal with ``seg_ptr`` at the
    block boundaries; its level plan covers every level, and the plain
    kernel run plan row by plan row equals one whole pass."""
    import torch
    from repro_torch.kernels.level_step import level_step_plain, narrow_width
    _, ts = suites([(80, 40), (81, 0), (82, 30)], classes=classes)
    pairs = [(2, 0), (2, 3)]
    a0 = np.array([40.0, 300.0, 7.0]) if classes else 50.0
    plan = tsuite._build_suite_plan(ts, pairs, 1.0, a0, False,
                                    n_classes=classes)
    lv = plan.lv
    assert lv.seg_ptr.tolist() == [0, 40, 40, 70, 110, 110, 140]
    assert plan.n == 140 and len(plan.blocks) == 6
    assert (plan.cls_mem is not None) == bool(classes)
    blk = np.repeat(np.arange(6), np.diff(lv.seg_ptr))
    src = lv.esrc
    dst = np.repeat(lv.run_dst, lv.run_lens)
    assert np.array_equal(blk[src], blk[dst])
    q = lv.qpred[lv.qpred < plan.n]
    assert np.array_equal(blk[q], blk[np.nonzero(lv.qpred < plan.n)[0]])
    rows = lv.level_plan(narrow_width(5))
    assert rows[:, 3].sum() == int((lv.level_widths()[1:] > 0).sum())
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.integers(1, 400, (plan.n + 1, 5)) / 4.0)
    base[-1] = 0.0
    whole, parts = base.clone(), base.clone()
    Rw, Rp = torch.zeros_like(base), torch.zeros_like(base)
    level_step_plain(lv, whole, clamp=False, R_out=Rw)
    for l0, l1, _, _ in rows.tolist():
        level_step_plain(lv, parts, clamp=False, R_out=Rp, levels=(l0, l1))
    assert torch.equal(whole, parts) and torch.equal(Rw, Rp)
