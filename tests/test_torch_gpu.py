"""Tests of the port that need the card: the CUDA level kernel against its
plain version, and the engine on the card against the engine on the host.

Marked ``gpu``; each test asks a fixture whether torch sees a CUDA device
and skips when it does not.  Run on a machine with the card:
``python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.apps import polybench
from repro_torch.core import backend as B
from repro_torch.core import scheduler as S
from repro_torch.core import sweep_report
from repro_torch.kernels.level_step import level_step, level_step_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cuda")
    for knob in ("EDAN_X64", "EDAN_REPLAY_DTYPE"):
        monkeypatch.delenv(knob, raising=False)
    return torch.device("cuda")


def _plan(name="gemm", N=10, m=4, cs=8):
    g = polybench.trace_kernel(name, N)
    g._finalize()
    _, plan = S._record_plan(g, g._sim_lists(), m, cs, 50.0, 1.0,
                             persist=False)
    return g, plan


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32
                               else torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("slot", [False, True])
def test_kernel_bitwise_vs_plain(card, dtype, slot):
    g, plan = _plan()
    lv = plan.lv if slot else g._level_csr()
    rows = lv.n + (1 if slot else 0)
    base = torch.from_numpy(np.random.default_rng(0).integers(
        1, 300, (rows, 6)) / 4.0).to(card, dtype)
    if slot:
        base[-1] = 0
    for clamp in (False, True):
        Fk, Fp = base.clone(), base.clone()
        Rk, Rp = torch.zeros_like(base), torch.zeros_like(base)
        n0 = level_step.launches
        level_step(lv, Fk, clamp=clamp, R_out=Rk)
        assert level_step.launches > n0
        level_step_plain(lv, Fp, clamp=clamp, R_out=Rp)
        torch.cuda.synchronize()
        assert torch.equal(_bits(Fk), _bits(Fp))
        assert torch.equal(_bits(Rk), _bits(Rp))


def test_kernel_propagates_nan_like_numpy(card):
    g = polybench.trace_kernel("atax", 6)
    lv = g._level_csr()
    base = np.random.default_rng(1).standard_normal(g.n_vertices)
    base[::7] = np.nan
    Fk = torch.from_numpy(base.copy()).to(card)
    Fp = torch.from_numpy(base.copy())
    level_step(lv, Fk)
    level_step_plain(lv, Fp)
    assert np.array_equal(Fk.cpu().numpy(), Fp.numpy(), equal_nan=True)


def test_wrapper_rejects_bad_inputs(card):
    g = polybench.trace_kernel("gemm", 4)
    lv = g._level_csr()
    with pytest.raises(ValueError, match="float32 or float64"):
        level_step(lv, torch.zeros((g.n_vertices, 2), dtype=torch.int32,
                                   device=card))
    with pytest.raises(ValueError, match="rows"):
        level_step(lv, torch.zeros((3, 2), device=card))
    with pytest.raises(ValueError, match="contiguous"):
        level_step(lv, torch.zeros((2, g.n_vertices), device=card).T)


def test_fault_hook_propagates(card, monkeypatch):
    def boom():
        raise RuntimeError("injected")
    monkeypatch.setattr(B, "fault_hook", boom)
    g = polybench.trace_kernel("gemm", 4)
    with pytest.raises(RuntimeError, match="injected"):
        g.finish_times()


@pytest.mark.parametrize("dtype", [None, "float64"])
def test_engine_on_card_equals_engine_on_host(card, dtype, monkeypatch):
    g = polybench.trace_kernel("lu", 10)
    B.reset_stats()
    on_card = sweep_report(g, [50.0, 125.0, 0.1, 300.0],
                           simulate_points=True, compute_slots=8,
                           replay_dtype=dtype)
    assert B.stats["cuda_chunks"] > 0 and B.stats["cpu_chunks"] == 0
    if dtype is None:
        assert B.stats["demoted_columns"] >= 1     # the 0.1 column
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    h = polybench.trace_kernel("lu", 10)
    on_host = sweep_report(h, [50.0, 125.0, 0.1, 300.0],
                           simulate_points=True, compute_slots=8)
    for k in on_host:
        assert np.array_equal(np.asarray(on_card[k]),
                              np.asarray(on_host[k])), k
