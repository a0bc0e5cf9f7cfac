"""The port's batched §4 simulator (``repro_torch.core.scheduler``) against
the JAX package's reference event loops and grids.

Tie-heavy random DAGs (small-integer alphas make event-time ties plentiful,
the adversarial case for the on-device (R, E, vid) and slot-provenance
checks) and PolyBench kernels at N=8 go through both packages; every
makespan must be bit-identical, under the float64 and the float32 policy.
"""
import numpy as np
import pytest

from repro.apps import polybench as rpoly
from repro.core import EDag as REDag
from repro.core import simulate_reference, simulate_reference_classes
from repro.core import sweep_grid as r_grid
from repro_torch.apps import polybench as tpoly
from repro_torch.core import EDag as TEDag
from repro_torch.core import latency_sweep, simulate_batch, sweep_grid
from repro_torch.core import scheduler as tsched
from repro_torch.core import simulate_reference as t_ref
from repro_torch.core import simulate_reference_classes as t_ref_cls

PALETTE = np.array([0.5, 1.0, 2.0, 3.0, 50.0, 200.0, 333.25])


@pytest.fixture(autouse=True)
def cpu_backend(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")
    for knob in ("EDAN_X64", "EDAN_REPLAY_DTYPE", "EDAN_BACKEND"):
        monkeypatch.delenv(knob, raising=False)


def _tie_pair(seed: int, n: int = 50, p: float = 0.12):
    rng = np.random.default_rng(seed)
    g = REDag()
    for i in range(n):
        g.add_vertex(is_mem=bool(rng.random() < 0.5), nbytes=8.0)
        for j in range(i):
            if rng.random() < p:
                g.add_edge(j, i)
    g._finalize()
    t = TEDag.from_arrays(g.cost, g.is_mem, g.nbytes, g.src, g.dst)
    return g, t, rng


@pytest.mark.parametrize("dtype", [None, "float32"])
@pytest.mark.parametrize("seed", range(6))
def test_simulate_batch_matches_reference(seed, dtype):
    g, t, rng = _tie_pair(seed)
    m, cs = int(rng.integers(1, 5)), int(rng.integers(0, 5))
    alphas = rng.choice(PALETTE, size=5, replace=False)
    want = np.array([simulate_reference(g, m=m, alpha=float(a),
                                        compute_slots=cs) for a in alphas])
    got = simulate_batch(t, alphas, m=m, compute_slots=cs,
                         replay_dtype=dtype)
    assert np.array_equal(got, want)
    assert all(t_ref(t, m=m, alpha=float(a), compute_slots=cs) == w
               for a, w in zip(alphas, want))


@pytest.mark.parametrize("seed", range(4))
def test_sweep_grid_matches_reference_grid(seed):
    g, t, rng = _tie_pair(seed + 10)
    alphas = list(rng.choice(PALETTE, size=4, replace=False)) + [50.0, 0.5]
    ms, css = (1, 2, 4), (0, 3)
    want = r_grid(g, alphas, ms=ms, compute_slots=css, use_cache=False)
    got = sweep_grid(t, alphas, ms=ms, compute_slots=css)
    assert np.array_equal(got, want)
    # a repeat starts from the per-EDag plan memo, one plan per pair
    hits = tsched.stats["memory_hits"]
    again = sweep_grid(t, alphas, ms=ms, compute_slots=css)
    assert np.array_equal(again, want)
    assert tsched.stats["memory_hits"] == hits + len(ms) * len(css)


@pytest.mark.parametrize("seed", range(5))
def test_class_grid_matches_class_reference(seed):
    g, t, rng = _tie_pair(seed + 20)
    C = int(rng.integers(1, 4))
    classes = rng.integers(0, C, size=g.n_vertices, dtype=np.int32)
    g.set_mem_classes(classes)
    t.set_mem_classes(classes)
    m, cs = int(rng.integers(1, 4)), int(rng.integers(0, 3))
    rows = rng.choice(PALETTE, size=(4, C))
    want = np.array([simulate_reference_classes(g, a, m=m, compute_slots=cs)
                     for a in rows])
    for dtype in (None, "float32"):
        got = simulate_batch(t, rows, m=m, compute_slots=cs,
                             replay_dtype=dtype)
        assert np.array_equal(got, want)
    assert np.array_equal(
        sweep_grid(t, rows, ms=(m,), compute_slots=(cs,))[:, 0, 0], want)
    assert all(t_ref_cls(t, a, m=m, compute_slots=cs) == w
               for a, w in zip(rows, want))


def test_degenerate_and_unsorted_alphas():
    g, t, _ = _tie_pair(3)
    alphas = [200.0, 50.0, 200.0, 3.0]
    want = np.array([simulate_reference(g, m=2, alpha=a) for a in alphas])
    assert np.array_equal(simulate_batch(t, alphas, m=2), want)
    assert np.array_equal(latency_sweep(t, alphas, m=2, batch=False), want)
    bad = [50.0, -1.0]
    assert np.array_equal(
        simulate_batch(t, bad, m=2),
        np.array([simulate_reference(g, m=2, alpha=a) for a in bad]))
    assert len(simulate_batch(t, [], m=2)) == 0


def test_small_replay_budget_chunks_identically():
    g, t, rng = _tie_pair(5)
    alphas = rng.choice(PALETTE, size=5, replace=False)
    want = simulate_batch(t, alphas, m=3, compute_slots=2)
    got = simulate_batch(t, alphas, m=3, compute_slots=2, mem_budget=1,
                         use_cache=False)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["gemm", "trisolv", "atax"])
def test_polybench_sweeps_match_reference(name):
    g = rpoly.trace_kernel(name, 8)
    t = tpoly.trace_kernel(name, 8)
    assert t.trace_digest() == g.trace_digest()
    alphas = [50.0, 125.0, 300.0]
    want = r_grid(g, alphas, ms=(2, 4), compute_slots=(0, 8),
                  use_cache=False)
    got = sweep_grid(t, alphas, ms=(2, 4), compute_slots=(0, 8),
                     replay_dtype="float32")
    assert np.array_equal(got, want)
    assert np.array_equal(got[:, 1, 1], [simulate_reference(
        g, m=4, alpha=a, compute_slots=8) for a in alphas])


@pytest.mark.parametrize("alphas", [[200.0, 50.0, 200.0], [50.0, 75.0],
                                    [[3.0, 1.0], [1.0, 2.0], [3.0, 1.0]],
                                    [50.0, -1.0], 25.0])
def test_sweep_spec_and_budget_match_reference(alphas, monkeypatch):
    from repro.core.plan import ExecPolicy as RPol, SweepSpec as RSpec
    from repro_torch.core.plan import ExecPolicy as TPol, SweepSpec as TSpec
    a = RSpec.make(alphas, ms=(2, 4), compute_slots=0, unit=1.0)
    b = TSpec.make(alphas, ms=(2, 4), compute_slots=0, unit=1.0)
    for f in ("alphas", "uniq", "ms", "css", "unit", "class_mode",
              "bad_costs"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.inv is None) == (b.inv is None)
    if a.inv is not None:
        assert np.array_equal(a.inv, b.inv)
    assert a.degenerate(1) == b.degenerate(1)
    for env in ("", "garbage", "-5", "4096"):
        monkeypatch.setenv("EDAN_REPLAY_MEM_BUDGET", env)
        ra, ta = RPol.resolve(), TPol.resolve()
        assert ra.mem_budget == ta.mem_budget
        assert ra.points_chunk(41200, 11) == ta.points_chunk(41200, 11)
