"""The port's recurrence kernels on the CPU: the plain versions of K2
(WKV6) and K3 (SSD) — chunked, and blocked as the CUDA kernels block —
against the reference package's oracles and its Pallas kernels in
interpret mode, state streaming across calls, the fault-1 input on which
the Pallas kernels overflow, and the dispatch.

Inputs are numpy arrays made from a seed and handed to both packages.
Tolerances are relative to the largest |reference| value: 2e-6 between
the two packages' chunked forms (the same float32 algorithm, summed in
another order; measured ~5e-7), 2e-5 between a chunked and a sequential
form (float32 rounding of the cumulative log-decay; measured <= 5e-6),
and between the kernels' blocked forms and the sequential oracle.
The CUDA kernels themselves are held to these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba2_ssd import ssd_pallas
from repro.kernels.rwkv6_wkv import wkv6_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.ssd import ssd as ssd_kernel
from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel


@pytest.fixture(autouse=True)
def _on_the_host(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")


SAME_ALGO = 2e-6
CHUNK_VS_SEQ = 2e-5


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def wkv_inputs(B, H, T, K, V, seed=0, decay=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = f(B, H, T, K), 0.3 * f(B, H, T, K), f(B, H, T, V)
    if decay is None:
        w = 1 / (1 + np.exp(-f(B, H, T, K))) * 0.5 + 0.45
    else:
        w = np.full((B, H, T, K), decay)
    return [a.astype(np.float32) for a in
            (r, k, v, w, 0.1 * f(H, K), 0.1 * f(B, H, K, V))]


def ssd_inputs(B, H, T, P, N, G, seed=0, fault=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(B, H, T, P)
    if fault:
        dt, A = np.full((B, H, T), 0.7), -np.ones(H)
    else:
        dt = 0.2 * np.log1p(np.exp(f(B, H, T)))
        A = -np.exp(0.3 * f(H))
    return [a.astype(np.float32) for a in
            (x, dt, A, 0.4 * f(B, G, T, N), 0.4 * f(B, G, T, N),
             0.1 * f(H), 0.1 * f(B, H, P, N))]


def port(fn, arrays, **kw):
    y, S = fn(*(torch.from_numpy(a) for a in arrays), **kw)
    return y.numpy(), S.numpy()


WKV_SHAPES = [
    # B, H, T, K, V, chunk (tests/test_kernels.py::test_wkv6_sweep)
    (1, 2, 64, 16, 16, 16),
    (2, 1, 128, 32, 32, 32),
    (1, 4, 96, 8, 24, 32),
    (2, 2, 64, 64, 64, 64),
]
SSD_SHAPES = [
    # B, H, T, P, N, G, chunk (tests/test_kernels.py::test_ssd_sweep)
    (1, 2, 64, 16, 8, 1, 16),
    (2, 4, 128, 32, 16, 2, 32),
    (1, 2, 96, 64, 64, 1, 32),
    (1, 1, 64, 16, 16, 1, 64),
]


@pytest.mark.parametrize("B,H,T,K,V,chunk", WKV_SHAPES)
def test_wkv6_plain_matches_reference(B, H, T, K, V, chunk):
    a = wkv_inputs(B, H, T, K, V)
    yj, Sj = jref.wkv6_chunked_ref(*a, chunk=chunk)
    y0, S0 = jref.wkv6_ref(*a)
    yc, Sc = port(ref.wkv6_chunked_ref, a, chunk=chunk)
    ys, Ss = port(ref.wkv6_ref, a)
    assert rel_err(yc, yj) < SAME_ALGO and rel_err(Sc, Sj) < SAME_ALGO
    assert rel_err(ys, y0) < SAME_ALGO and rel_err(Ss, S0) < SAME_ALGO
    assert rel_err(yc, y0) < CHUNK_VS_SEQ and rel_err(Sc, S0) < CHUNK_VS_SEQ


@pytest.mark.parametrize("B,H,T,P,N,G,chunk", SSD_SHAPES)
def test_ssd_plain_matches_reference(B, H, T, P, N, G, chunk):
    a = ssd_inputs(B, H, T, P, N, G)
    yj, Sj = jref.ssd_chunked_ref(*a, chunk=chunk)
    y0, S0 = jref.ssd_ref(*a)
    yc, Sc = port(ref.ssd_chunked_ref, a, chunk=chunk)
    ys, Ss = port(ref.ssd_ref, a)
    assert rel_err(yc, yj) < SAME_ALGO and rel_err(Sc, Sj) < SAME_ALGO
    assert rel_err(ys, y0) < SAME_ALGO and rel_err(Ss, S0) < SAME_ALGO
    assert rel_err(yc, y0) < CHUNK_VS_SEQ and rel_err(Sc, S0) < CHUNK_VS_SEQ


@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
def test_state_streams_across_calls(kind):
    """Two halves with the state carried equal one pass: the prefill to
    decode handoff."""
    if kind == "wkv6":
        a, fn, split = wkv_inputs(1, 2, 64, 16, 16, seed=3), \
            ops.wkv6, (0, 1, 2, 3)
    else:
        a, fn, split = ssd_inputs(2, 4, 64, 16, 8, 2, seed=3), \
            ops.ssd, (0, 1, 3, 4)
    t = [torch.from_numpy(x) for x in a]
    y_full, S_full = fn(*t, chunk=16)
    first, second = list(t), list(t)
    for i in split:
        first[i] = t[i][:, :, :32]
        second[i] = t[i][:, :, 32:]
    y1, S_mid = fn(*first, chunk=16)
    second[-1] = S_mid
    y2, S_end = fn(*second, chunk=16)
    assert rel_err(torch.cat([y1, y2], 2), y_full) < SAME_ALGO
    assert rel_err(S_end, S_full) < SAME_ALGO


@pytest.mark.parametrize("case", [(1, 2, 64, 16, 16, 16),
                                  (1, 4, 96, 8, 24, 16)])
def test_wkv6_plain_matches_pallas_interpret(case):
    B, H, T, K, V, chunk = case
    a = wkv_inputs(B, H, T, K, V, seed=5)
    yp, Sp = wkv6_pallas(*map(jnp.asarray, a), chunk=chunk, interpret=True)
    yc, Sc = port(ops.wkv6, a, chunk=chunk)
    assert rel_err(yc, yp) < SAME_ALGO and rel_err(Sc, Sp) < SAME_ALGO


def test_ssd_plain_matches_pallas_interpret():
    a = ssd_inputs(2, 4, 64, 16, 8, 2, seed=5)
    yp, Sp = ssd_pallas(*map(jnp.asarray, a), chunk=16, interpret=True)
    yc, Sc = port(ops.ssd, a, chunk=16)
    assert rel_err(yc, yp) < SAME_ALGO and rel_err(Sc, Sp) < SAME_ALGO


def test_fault1_wkv6_finite_where_pallas_overflows():
    """T=256 at the configs' chunk of 256 with decay e^-1 (rwkv6's init):
    the Pallas kernel's exp(-cs) overflows; the port's plain version stays
    finite and equals the sequential oracle."""
    a = wkv_inputs(1, 2, 256, 64, 64, seed=7, decay=np.exp(-1.0))
    yp, _ = wkv6_pallas(*map(jnp.asarray, a), chunk=256, interpret=True)
    assert not np.isfinite(np.asarray(yp)).all()
    y0, S0 = jref.wkv6_ref(*a)
    yc, Sc = port(ops.wkv6, a, chunk=256)
    assert np.isfinite(yc).all() and np.isfinite(Sc).all()
    assert rel_err(yc, y0) < CHUNK_VS_SEQ and rel_err(Sc, S0) < CHUNK_VS_SEQ


def test_fault1_ssd_finite_where_pallas_overflows():
    """T=256, chunk 256, dt=0.7 and A=-1 (mamba2's init): as above."""
    a = ssd_inputs(1, 4, 256, 64, 64, 1, seed=7, fault=True)
    yp, _ = ssd_pallas(*map(jnp.asarray, a), chunk=256, interpret=True)
    assert not np.isfinite(np.asarray(yp)).all()
    y0, S0 = jref.ssd_ref(*a)
    yc, Sc = port(ops.ssd, a, chunk=256)
    assert np.isfinite(yc).all() and np.isfinite(Sc).all()
    assert rel_err(yc, y0) < CHUNK_VS_SEQ and rel_err(Sc, S0) < CHUNK_VS_SEQ


#: ragged lengths for the kernels' blocking: shorter than one block (K2's
#: 16, K3's 64), one past a block, several blocks and a tail
BLOCKED_T = (1, 15, 17, 37, 200)


@pytest.mark.parametrize("T", BLOCKED_T)
def test_wkv6_blocked_matches_reference(T):
    """K2's blocking (16 tokens, the tail shorter) against the JAX
    package's sequential oracle."""
    a = wkv_inputs(1, 2, T, 16, 24, seed=T)
    y0, S0 = jref.wkv6_ref(*a)
    yb, Sb = port(ref.wkv6_blocked_ref, a)
    assert yb.shape == (1, 2, T, 24)
    assert rel_err(yb, y0) < CHUNK_VS_SEQ and rel_err(Sb, S0) < CHUNK_VS_SEQ


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("T", BLOCKED_T)
def test_ssd_blocked_matches_reference(T, G):
    """K3's blocking (64 tokens, the tail shorter) against the JAX
    package's sequential oracle, with one group and with two."""
    a = ssd_inputs(1, 4, T, 16, 16, G, seed=T)
    y0, S0 = jref.ssd_ref(*a)
    yb, Sb = port(ref.ssd_blocked_ref, a)
    assert yb.shape == (1, 4, T, 16)
    assert rel_err(yb, y0) < CHUNK_VS_SEQ and rel_err(Sb, S0) < CHUNK_VS_SEQ


@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
def test_fault1_blocked_finite(kind):
    """The fault-1 inputs (T=256, decay e^-1 and dt=0.7, A=-1) through the
    kernels' blocking: finite and equal to the sequential oracle."""
    if kind == "wkv6":
        a = wkv_inputs(1, 2, 256, 64, 64, seed=7, decay=np.exp(-1.0))
        y0, S0 = jref.wkv6_ref(*a)
        yb, Sb = port(ref.wkv6_blocked_ref, a)
    else:
        a = ssd_inputs(1, 4, 256, 64, 64, 1, seed=7, fault=True)
        y0, S0 = jref.ssd_ref(*a)
        yb, Sb = port(ref.ssd_blocked_ref, a)
    assert np.isfinite(yb).all() and np.isfinite(Sb).all()
    assert rel_err(yb, y0) < CHUNK_VS_SEQ and rel_err(Sb, S0) < CHUNK_VS_SEQ


def test_kernel_wrappers_take_cuda_tensors_only():
    """On CPU tensors the CUDA wrappers raise rather than fall back; the
    dispatch sends CPU tensors to the plain version."""
    a = [torch.from_numpy(x) for x in wkv_inputs(1, 2, 8, 16, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_kernel(*a)
    b = [torch.from_numpy(x) for x in ssd_inputs(1, 2, 8, 16, 8, 1)]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel(*b)
    assert wkv6_kernel.launches == 0 and ssd_kernel.launches == 0
    y, _ = ops.wkv6(*a)
    assert y.shape == (1, 2, 8, 16)
    with pytest.raises(ValueError, match="all on"):
        ops.ssd(*b[:-1], b[-1].to("meta"))
