"""The plain reference against the program's CPU path at small sizes:
the same eDAGs and makespans, bit for bit."""
import numpy as np
import pytest

from edanbench.reference import hpcg_cg, machine, polybench

ALPHAS = np.linspace(50, 300, 13)


def _same_dag(g, r):
    g._finalize()
    assert g.n_vertices == r.n
    assert np.array_equal(g.is_mem, r.is_mem)
    assert np.array_equal(np.asarray(g.src), r.src)
    assert np.array_equal(np.asarray(g.dst), r.dst)


@pytest.mark.parametrize("name", sorted(polybench.KERNELS))
def test_polybench_matches_the_program(name, cpu_env, monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")
    from repro_torch.apps.polybench import trace_kernel
    from repro_torch.core.metrics import grid_report
    g = trace_kernel(name, 6, seed=7)
    r = polybench.trace_one(name, 6, 7)
    _same_dag(g, r)
    ms, css = (2, 8), (0, 8)
    got = grid_report(g, ALPHAS, ms=ms, compute_slots=css,
                      simulate_points=True)
    for p in [(0, 0, 0), (5, 1, 1), (12, 0, 1), (7, 1, 0)]:
        assert got["simulated"][p] == machine.makespan(
            r, ms[p[1]], float(ALPHAS[p[0]]), 1.0, css[p[2]])


def test_hpcg_matches_the_program(cpu_env, monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")
    from repro_torch.apps.hpcg import trace_cg
    from repro_torch.core.scheduler import sweep_grid
    g = trace_cg(n=4, iters=2, seed=5)[0]
    r = hpcg_cg.trace_cg(4, 2, 5)
    _same_dag(g, r)
    alphas = np.arange(50.0, 301.0, 25.0)
    got = sweep_grid(g, alphas, ms=(4,), compute_slots=(8,))
    for i in (0, 4, 10):
        assert got[i, 0, 0] == machine.makespan(r, 4, alphas[i], 1.0, 8)


def test_the_seed_changes_values_not_the_graph():
    a, b = polybench.trace_one("gemm", 5, 1), polybench.trace_one("gemm", 5, 2)
    assert np.array_equal(a.src, b.src) and np.array_equal(a.is_mem, b.is_mem)


def test_float32_rounds_where_float64_is_exact():
    r = polybench.trace_one("atax", 6, 0)
    a = float(ALPHAS[1])
    assert machine.makespan(r, 2, a, 1.0, 0, "float32") != \
        machine.makespan(r, 2, a, 1.0, 0)
