"""The port's flash attention on the CPU: the plain version of K4
(``kernels.ref.flash_attention_plain``) against the reference package's
Pallas kernel in interpret mode, at ragged lengths against the port's
``attention_ref``; the plain version that rounds P to bf16 as the bf16
kernel does (``round_p=True``) against the Pallas kernel and the JAX
package's ``attention_ref`` in bf16; the dispatch of
``ops.flash_attention`` for CPU tensors; the kernel wrapper's checks.

Inputs are numpy arrays made from a seed and handed to both packages.
Against the Pallas kernel (the same float32 online softmax, summed in
another order) the tolerances are the reference's own tests': 1e-5 in
float32, 2e-2 in bf16 (one bf16 rounding of the output).  Against
``attention_ref``, which rounds the probabilities to v's dtype before the
product (so in float32 only the summation order differs), 1e-5.  The
CUDA kernel is held to the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention as kernel
from repro_torch.kernels.ref import flash_attention_plain
from repro_torch.models.layers import attention_ref

# tests/test_kernels.py's ATT_SHAPES: B, T, S, H, KV, hd, bq, bkv
ATT_SHAPES = [
    (1, 128, 128, 4, 4, 64, 64, 64),
    (2, 256, 256, 4, 2, 64, 128, 128),
    (1, 128, 128, 8, 1, 128, 64, 32),
    (2, 64, 64, 2, 2, 32, 64, 64),
]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def inputs(B, T, S, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


def both(arrays, dtype):
    """The same inputs for the reference (jnp) and the port (torch)."""
    return ([jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,S,H,KV,hd,bq,bkv", ATT_SHAPES)
def test_plain_matches_pallas(B, T, S, H, KV, hd, bq, bkv, dtype, causal):
    J, P = both(inputs(B, T, S, H, KV, hd), dtype)
    want = flash_attention_pallas(*J, causal=causal, block_q=bq,
                                  block_kv=bkv, interpret=True)
    got = flash_attention_plain(*P, causal=causal, block_q=bq, block_kv=bkv)
    assert got.dtype == P[0].dtype
    close(got, want, TOL[dtype])


def test_plain_matches_pallas_window():
    J, P = both(inputs(1, 256, 256, 2, 2, 64, seed=1), "float32")
    want = flash_attention_pallas(*J, causal=True, window=64, block_q=64,
                                  block_kv=64, interpret=True)
    close(flash_attention_plain(*P, causal=True, window=64, block_q=64,
                                block_kv=64), want, TOL["float32"])


@pytest.mark.parametrize("hd,H,KV", [(96, 4, 4), (112, 4, 2)])
def test_plain_matches_pallas_head_dims(hd, H, KV):
    """phi3's heads of 96 and zamba2's of 112 (not powers of two)."""
    J, P = both(inputs(1, 256, 256, H, KV, hd, seed=hd), "float32")
    want = flash_attention_pallas(*J, causal=True, block_q=128,
                                  block_kv=128, interpret=True)
    close(flash_attention_plain(*P, causal=True), want, TOL["float32"])


@pytest.mark.parametrize("T,S,causal,window", [
    (200, 200, True, 0), (37, 37, True, 0), (200, 200, True, 48),
    (128, 384, False, 0), (70, 70, False, 16)])
def test_plain_at_ragged_lengths_matches_attention_ref(T, S, causal, window):
    """Any T and S, where the Pallas kernel asserts T % block_q == 0:
    against the port's attention_ref (one chunk of all S keys)."""
    P = [torch.from_numpy(a) for a in inputs(2, T, S, 4, 2, 16, seed=T)]
    want = attention_ref(*P, causal=causal, window=window, chunk_kv=S)
    got = flash_attention_plain(*P, causal=causal, window=window,
                                block_q=64, block_kv=64)
    close(got, want.numpy(), TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,block_kv", [(0, 16), (0, 1024), (5, 4)])
def test_ops_on_cpu_tensors_is_attention_ref(dtype, window, block_kv):
    """``ops.flash_attention`` on CPU tensors returns ``attention_ref``'s
    result bit for bit, with ``block_kv`` as its chunk."""
    P = both(inputs(2, 24, 24, 4, 2, 16, seed=3), dtype)[1]
    got = ops.flash_attention(*P, causal=True, window=window,
                              block_kv=block_kv)
    want = attention_ref(*P, causal=True, window=window, chunk_kv=block_kv)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_domain_without_keys_raises():
    """A query row that sees no key has no softmax: both the plain
    version and the kernel refuse such inputs."""
    P = [torch.from_numpy(a) for a in inputs(1, 40, 8, 2, 2, 16)]
    for fn in (flash_attention_plain, kernel):
        with pytest.raises(ValueError, match="see no key"):
            fn(*P, causal=True, window=16)
        with pytest.raises(ValueError, match="empty key"):
            fn(P[0], P[1][:, :0], P[2][:, :0], causal=False)


def test_kernel_wrapper_checks_and_never_falls_back():
    """The CUDA wrapper takes no CPU tensor (there is no fallback to the
    plain version) and checks shapes and dtypes first."""
    q, k, v = (torch.from_numpy(a) for a in inputs(1, 16, 16, 4, 2, 16))
    n0 = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel(q, k, v)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernel(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(ValueError, match="multiple of 8 up to 128"):
        z = torch.zeros(1, 4, 2, 136)
        kernel(z, z, z)
    with pytest.raises(ValueError, match="not a multiple of KV"):
        kernel(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="one dtype"):
        kernel(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="differ"):
        kernel(q, k, v[:, :8])
    assert kernel.launches == n0


# --------------------------- plain version that rounds P as the bf16 kernel

from repro.models.layers import attention_ref as jax_attention_ref  # noqa: E402

#: (B, T, S, H, KV, hd, causal, window): heads of 8, 40 and 112, a window,
#: non-causal T != S, a ragged T
ROUND_P_SHAPES = [
    (2, 64, 64, 4, 2, 8, True, 0),
    (1, 64, 64, 4, 4, 40, True, 0),
    (1, 128, 128, 4, 2, 112, True, 0),
    (1, 128, 128, 4, 2, 64, True, 32),
    (2, 32, 96, 4, 1, 40, False, 0),
    (1, 37, 37, 4, 2, 16, True, 0),
]
#: round_p against attention_ref, which rounds P the same way: in float32
#: the two differ only in summation order.  That can flip the bf16
#: rounding of an output (one ulp, at most 2^-7 of the value) or of a
#: probability p (which moves an output by 2^-8 p/l |v|, measured up to
#: 1.2e-4 of the largest output): rtol 2^-7, atol 2^-10 of the largest.
ROUND_P_ULP = 2.0 ** -7
ROUND_P_ATOL = 2.0 ** -10


@pytest.mark.parametrize("B,T,S,H,KV,hd,causal,window", ROUND_P_SHAPES)
def test_round_p_plain_matches_pallas_bf16(B, T, S, H, KV, hd, causal,
                                           window):
    """The plain version with P rounded to bf16 against the Pallas kernel
    in interpret mode (which keeps P in float32), within the reference's
    own bf16 tolerance (2e-2; rounding P adds at most 2^-9 of each
    probability).  One block of all T and S rows, so any T and S pass the
    Pallas kernel's divisibility assertion."""
    J, P = both(inputs(B, T, S, H, KV, hd, seed=hd + T), "bfloat16")
    want = flash_attention_pallas(*J, causal=causal, window=window,
                                  block_q=T, block_kv=S, interpret=True)
    got = flash_attention_plain(*P, causal=causal, window=window,
                                block_kv=64, round_p=True)
    assert got.dtype == torch.bfloat16
    close(got, want, TOL["bfloat16"])


@pytest.mark.parametrize("B,T,S,H,KV,hd,causal,window", ROUND_P_SHAPES)
def test_round_p_plain_matches_jax_attention_ref_bf16(B, T, S, H, KV, hd,
                                                      causal, window):
    """Against the JAX package's attention_ref in bf16 (P rounded to v's
    dtype before the product there too), over the same KV chunks, within
    ROUND_P_ULP and ROUND_P_ATOL; without round_p the difference is
    larger."""
    J, P = both(inputs(B, T, S, H, KV, hd, seed=hd + T), "bfloat16")
    chunk = 32 if S % 32 == 0 else S
    want = np.asarray(jax_attention_ref(*J, causal=causal, window=window,
                                        chunk_kv=chunk), np.float32)
    got = flash_attention_plain(*P, causal=causal, window=window,
                                block_kv=chunk, round_p=True)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=ROUND_P_ULP,
                               atol=ROUND_P_ATOL * np.abs(want).max())
    unrounded = flash_attention_plain(*P, causal=causal, window=window,
                                      block_kv=chunk)
    d_round = np.abs(got.float().numpy() - want).max()
    d_plain = np.abs(unrounded.float().numpy() - want).max()
    assert d_round < d_plain


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
def test_round_p_is_inert_in_float32(causal, window):
    """Rounding P to v's dtype is the identity for float32 inputs."""
    P = [torch.from_numpy(a) for a in inputs(1, 48, 48, 4, 2, 40, seed=2)]
    a = flash_attention_plain(*P, causal=causal, window=window, block_kv=16)
    b = flash_attention_plain(*P, causal=causal, window=window, block_kv=16,
                              round_p=True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("bkv", [64, 128])
def test_tile_probe_source_changes_only_the_tile(bkv):
    """The tile-size probe (``launch.att_tiles``) builds the kernel's own
    source with one line changed: the keys per bf16 tile."""
    from repro_torch.kernels.cuda_build import CSRC
    from repro_torch.launch.att_tiles import variant_source
    src = (CSRC / "flash_attention.cu").read_text().splitlines()
    var = variant_source(bkv).splitlines()
    diff = [(a, b) for a, b in zip(src, var) if a != b]
    assert len(var) == len(src)
    assert len(diff) <= 1
    assert f"constexpr int kTcBKV = {bkv};" in var
