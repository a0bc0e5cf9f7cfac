"""The port's frontend and reports end to end against the JAX package.

Tracers: every PolyBench kernel of figs 10-13, HPCG and LULESH traced by
both packages must give the same ``trace_digest`` (and the same arrays).
Reports: every field of ``sweep_report`` / ``grid_report`` / ``report`` and
of the paper runner's figures at small sizes must be bit-identical.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from repro.apps import hpcg as rhpcg
from repro.apps import lulesh as rlulesh
from repro.apps import polybench as rpoly
from repro.core import (CostModelParams, build_edag_from_trace,
                        data_movement_over_time, grid_report, lambda_rel,
                        make_cache, report, sweep_report)
from repro.core import cost as rcost
from repro_torch import core as T
from repro_torch.apps import hpcg as thpcg
from repro_torch.apps import lulesh as tlulesh
from repro_torch.apps import polybench as tpoly
from repro_torch.configs import paper_suite as tsuite
from repro_torch.launch import paper

KERNELS = rpoly.PAPER_15 + ["trmm_spill", "cholesky", "durbin"]
SUM_TRACE = """
add a3,a0,a1
mv a0,zero
lw a4,0(a5);0x40080290
addi a5,a5,4
addw a0,a0,a4
bne a3,a5,-6
lw a4,0(a5);0x40080294
addi a5,a5,4
addw a0,a0,a4
sw a0,0(a6);0x40080300
lw a7,0(a6);0x40080300
""".strip().splitlines()


@pytest.fixture(autouse=True)
def cpu_backend(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")
    for knob in ("EDAN_X64", "EDAN_REPLAY_DTYPE", "EDAN_BACKEND"):
        monkeypatch.delenv(knob, raising=False)


def _same_graph(r, t):
    assert t.trace_digest() == r.trace_digest()
    for name in ("cost", "is_mem", "nbytes", "src", "dst"):
        assert np.array_equal(getattr(r, name), getattr(t, name)), name
    assert list(t.labels()) == list(r.labels())


def _same(a, b):
    """Recursive exact equality of report values (arrays bitwise)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (np.ndarray, list, tuple)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


def test_paper_suite_settings_match():
    from dataclasses import asdict
    from repro.configs import paper_suite as rsuite
    assert asdict(tsuite.ANALYSIS) == asdict(rsuite.ANALYSIS)
    for k in ("POLYBENCH_N", "SIM_COMPUTE_SLOTS", "HPCG_N", "HPCG_ITERS",
              "LULESH_NE", "LULESH_ITERS"):
        assert getattr(tsuite, k) == getattr(rsuite, k), k
    assert tpoly.PAPER_15 == rpoly.PAPER_15
    assert sorted(tpoly.SCALAR_KERNELS) == sorted(rpoly.SCALAR_KERNELS)


@pytest.mark.parametrize("cache", [0, 32 * 1024])
@pytest.mark.parametrize("name", KERNELS)
def test_polybench_trace_digests(name, cache):
    r = rpoly.trace_kernel(name, 6, cache=make_cache(cache))
    t = tpoly.trace_kernel(name, 6, cache=T.make_cache(cache))
    _same_graph(r, t)


@pytest.mark.parametrize("name,regs,false_deps", [
    ("trmm", 3, False), ("trmm", 8, False), ("gemm", 4, True),
    ("lu", None, True), ("atax", 2, False)])
def test_spill_and_false_dep_traces(name, regs, false_deps):
    r = rpoly.trace_kernel(name, 6, max_regs=regs, false_deps=false_deps)
    t = tpoly.trace_kernel(name, 6, max_regs=regs, false_deps=false_deps)
    _same_graph(r, t)
    assert r.mem_layers().D == t.mem_layers().D


@pytest.mark.parametrize("cache", [0, 32 * 1024])
def test_hpcg_and_lulesh_traces(cache):
    r, rres = rhpcg.trace_cg(n=4, iters=2, cache=make_cache(cache))
    t, tres = thpcg.trace_cg(n=4, iters=2, cache=T.make_cache(cache))
    _same_graph(r, t)
    assert rres == tres
    assert np.array_equal(rhpcg.spmv_numpy(np.arange(64.0), 4),
                          thpcg.spmv_numpy(np.arange(64.0), 4))
    r = rlulesh.trace_step(ne=3, iters=1, cache=make_cache(cache))
    t = tlulesh.trace_step(ne=3, iters=1, cache=T.make_cache(cache))
    _same_graph(r, t)
    assert np.array_equal(rlulesh.mesh_connectivity(3),
                          tlulesh.mesh_connectivity(3))


@pytest.mark.parametrize("false_deps", [False, True])
def test_algorithm1_text_trace(false_deps):
    r = build_edag_from_trace(SUM_TRACE, cache=make_cache(32 * 1024),
                              false_deps=false_deps)
    t = T.build_edag_from_trace(SUM_TRACE, cache=T.make_cache(32 * 1024),
                                false_deps=false_deps)
    _same_graph(r, t)


def _app_pair(app: str, cache: int):
    if app == "hpcg":
        return (rhpcg.trace_cg(n=4, iters=2, cache=make_cache(cache))[0],
                thpcg.trace_cg(n=4, iters=2, cache=T.make_cache(cache))[0])
    return (rlulesh.trace_step(ne=3, iters=1, cache=make_cache(cache)),
            tlulesh.trace_step(ne=3, iters=1, cache=T.make_cache(cache)))


@pytest.mark.parametrize("app", ["hpcg", "lulesh"])
@pytest.mark.parametrize("cache", [0, 32 * 1024])
def test_report_and_data_movement(app, cache):
    """Tables 1-2 and figs 9/15/16 at a small size: every report field and
    the whole data-movement curve."""
    r, t = _app_pair(app, cache)
    params = CostModelParams(m=4, alpha=200.0, alpha0=1.0)
    a = report(r, params)
    b = T.report(t, T.CostModelParams(m=4, alpha=200.0, alpha0=1.0))
    assert a.row() == b.row()
    assert np.array_equal(a.layer_sizes, b.layer_sizes)
    for tau in (1.0, 100.0):
        t0, U0 = data_movement_over_time(r, 200.0, tau=tau)
        t1, U1 = T.data_movement_over_time(t, 200.0, tau=tau)
        assert np.array_equal(t0, t1) and np.array_equal(U0, U1)
    _same(rcost.analyze(r), T.analyze(t))
    assert rcost.layered_upper_bound(a.layer_sizes, 4, 200.0) == \
        T.layered_upper_bound(b.layer_sizes, 4, 200.0)


@pytest.mark.parametrize("dtype", [None, "float32", "float64"])
@pytest.mark.parametrize("name", ["gemm", "lu", "trisolv", "gesummv"])
def test_sweep_and_grid_reports(name, dtype):
    r = rpoly.trace_kernel(name, 8)
    t = tpoly.trace_kernel(name, 8)
    alphas = tsuite.ANALYSIS.alpha_sweep
    a = sweep_report(r, alphas, simulate_points=True, compute_slots=8,
                     use_cache=False)
    b = T.sweep_report(t, alphas, simulate_points=True, compute_slots=8,
                       replay_dtype=dtype)
    _same(a, b)
    a = grid_report(r, alphas, ms=(2, 4), compute_slots=(0, 8),
                    simulate_points=True, use_cache=False)
    b = T.grid_report(t, alphas, ms=(2, 4), compute_slots=(0, 8),
                      simulate_points=True, replay_dtype=dtype)
    _same(a, b)


def test_class_grid_report():
    r = rpoly.trace_kernel("gemm", 6)
    t = tpoly.trace_kernel("gemm", 6)
    cls = np.arange(r.n_vertices) % 2
    r.set_mem_classes(cls)
    t.set_mem_classes(cls)
    rows = np.array([[50.0, 200.0], [100.0, 100.0]])
    a = grid_report(r, rows, ms=(4,), compute_slots=(8,),
                    simulate_points=True, use_cache=False)
    b = T.grid_report(t, rows, ms=(4,), compute_slots=(8,),
                      simulate_points=True)
    _same(a, b)


def _reference_api():
    return SimpleNamespace(
        polybench=rpoly, hpcg=rhpcg, lulesh=rlulesh, make_cache=make_cache,
        data_movement_over_time=data_movement_over_time,
        sweep_report=sweep_report, report=report,
        CostModelParams=CostModelParams, lambda_rel=lambda_rel)


def _holds(ref, got, path=""):
    """Every value of the reference's own figure result is in ``got``,
    numbers exactly equal (``got`` may hold more keys)."""
    if isinstance(ref, dict):
        for k in ref:
            _holds(ref[k], got[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ref) == len(got), path
        for i, (a, b) in enumerate(zip(ref, got)):
            _holds(a, b, f"{path}[{i}]")
    elif isinstance(ref, (int, float, np.number)) and \
            not isinstance(ref, bool):
        assert float(ref) == float(got), path
    else:
        assert ref == got, path


@pytest.mark.parametrize("fig", ["fig10_11", "fig12"])
def test_runner_figures_small(fig):
    """The runner's figures 10-12 at N=8, driven once by each engine, and
    held to the reference's own figure code (``benchmarks``)."""
    from benchmarks import fig10_11_lambda, fig12_Lambda
    fn = getattr(paper, fig)
    want = fn(_reference_api(), None, N=8)
    got = fn(paper.port_api(), T.ExecPolicy.resolve(replay_dtype="float32"),
             N=8)
    _same(want, got)
    lines = paper.detail_lines(fig, got)
    assert lines == paper.detail_lines(fig, want)
    assert paper.derived(fig, got) == paper.derived(fig, want)
    own = (fig10_11_lambda if fig == "fig10_11" else fig12_Lambda).run(N=8)
    _holds(own, got)


def test_runner_cli_smoke(capsys, monkeypatch):
    monkeypatch.setattr(paper, "FIG13_SIZES", (4, 6))
    res = paper.main(["--only", "fig13"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[1].startswith("fig13_depth_vs_N,")
    assert res["fig13"]["trmm_spill"] == [
        rpoly.trace_kernel("trmm_spill", n).mem_layers().D for n in (4, 6)]
    with pytest.raises(SystemExit):
        paper.main(["--only", "fig99"])
