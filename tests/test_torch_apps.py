"""The apps' PyTorch twins against the JAX package's twins and numpy, on
the CPU.

The eleven PolyBench twins (``polybench.TORCH_KERNELS``), CG
(``hpcg.cg_torch``) and LULESH (``lulesh.run_torch``) run on seeded numpy
inputs: in float32 they are held to the JAX twins (relative error 1e-5),
in float64 to numpy (1e-10): ``polybench.twin_numpy``,
``hpcg.reference_solution`` and ``lulesh.lulesh_numpy``.
Relative error is max |a - b| over max |b|, per output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import hpcg as rhpcg
from repro.apps import lulesh as rlulesh
from repro.apps import polybench as rpoly
from repro_torch.apps import hpcg, lulesh, polybench

F32_TOL, F64_TOL = 1e-5, 1e-10


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def test_the_twins_are_the_references():
    assert list(polybench.TORCH_KERNELS) == list(rpoly.JAX_KERNELS)
    assert set(polybench.TWIN_ARGS) == set(rpoly.JAX_KERNELS)


@pytest.mark.parametrize("N", [8, 20])
@pytest.mark.parametrize("name", list(polybench.TORCH_KERNELS))
def test_polybench_twin_float32_vs_jax(name, N):
    args = polybench.twin_inputs(name, N, seed=3)
    got = outputs(polybench.TORCH_KERNELS[name](
        *[torch.tensor(a, dtype=torch.float32) for a in args]))
    want = outputs(rpoly.JAX_KERNELS[name](
        *[jnp.asarray(a, jnp.float32) for a in args]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert rel(g.numpy(), np.asarray(w)) < F32_TOL


@pytest.mark.parametrize("N", [8, 20])
@pytest.mark.parametrize("name", list(polybench.TORCH_KERNELS))
def test_polybench_twin_float64_vs_numpy(name, N):
    args = polybench.twin_inputs(name, N, seed=4)
    got = outputs(polybench.TORCH_KERNELS[name](
        *[torch.from_numpy(a) for a in args]))
    want = polybench.twin_numpy(name, args)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert rel(g.numpy(), w) < F64_TOL


def test_trisolv_solves():
    L, b = polybench.twin_inputs("trisolv", 12, seed=5)
    x = polybench.TORCH_KERNELS["trisolv"](torch.from_numpy(L),
                                           torch.from_numpy(b))
    assert rel(L @ x.numpy(), b) < F64_TOL


@pytest.mark.parametrize("n", [5, 8])
def test_spmv_twin_equals_numpy(n):
    p = np.random.default_rng(n).standard_normal(n ** 3)
    got = hpcg.spmv_torch(torch.from_numpy(p), n).numpy()
    assert np.array_equal(got, hpcg.spmv_numpy(p, n))


@pytest.mark.parametrize("n,iters", [(5, 4), (8, 6)])
def test_cg_twin_float64_vs_numpy(n, iters):
    x_ref, hist_ref = hpcg.reference_solution(n, iters)
    b = torch.from_numpy(hpcg.build_problem(n))
    x, hist = hpcg.cg_torch(b, n, iters)
    assert rel(hist.numpy(), hist_ref) < F64_TOL
    assert rel(x.numpy(), x_ref) < F64_TOL
    assert hist_ref[-1] < hist_ref[0]
    # the port's numpy oracle is the reference's
    assert np.array_equal(hist_ref, rhpcg.reference_solution(n, iters)[1])


@pytest.mark.parametrize("n,iters", [(5, 4), (8, 6)])
def test_cg_twin_float32_vs_jax(n, iters):
    b = hpcg.build_problem(n)
    x, hist = hpcg.cg_torch(torch.tensor(b, dtype=torch.float32), n, iters)
    xj, hj = rhpcg.cg_jax(jnp.asarray(b, jnp.float32), n, iters)
    assert rel(hist.numpy(), np.asarray(hj)) < F32_TOL
    assert rel(x.numpy(), np.asarray(xj)) < F32_TOL


@pytest.mark.parametrize("ne,iters", [(3, 2), (6, 3)])
def test_lulesh_twin_float64_vs_numpy(ne, iters):
    (state, hist) = lulesh.run_torch(ne, iters, device="cpu")
    ref_state, ref_hist = lulesh.lulesh_numpy(ne, iters)
    assert rel(hist.numpy(), ref_hist) < F64_TOL
    for s, r in zip(state, ref_state):
        assert s.dtype == torch.float64
        assert rel(s.numpy(), r) < F64_TOL


@pytest.mark.parametrize("ne,iters", [(3, 2), (6, 3)])
def test_lulesh_twin_float32_vs_jax(ne, iters):
    state, hist = lulesh.run_torch(ne, iters, device="cpu",
                                   dtype=torch.float32)
    jstate, jhist = rlulesh.run_jax(ne, iters)
    assert rel(hist.numpy(), np.asarray(jhist)) < F32_TOL
    for s, r in zip(state, jstate):
        assert rel(s.numpy(), np.asarray(r)) < F32_TOL



def test_lulesh_twin_defaults_to_the_selected_backend(monkeypatch):
    monkeypatch.delenv("EDAN_TORCH_BACKEND", raising=False)
    if torch.cuda.is_available():
        assert lulesh.run_torch(3, 1)[0][0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda backend"):
            lulesh.run_torch(3, 1)
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    state, hist = lulesh.run_torch(3, 1)
    assert state[0].device.type == hist.device.type == "cpu"
