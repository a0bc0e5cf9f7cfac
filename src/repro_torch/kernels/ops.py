"""Dispatch of the model zoo's kernels, by the device of the tensors: a
CUDA tensor goes to the hand-written kernel (``wkv6.py``, ``ssd.py``,
``flash_attention.py``), a CPU tensor to what the reference package's
models run on the CPU (the chunked recurrences of ``ref.py``,
``models.layers.attention_ref``).  A ``meta`` tensor carries no data, so
no kernel can run on it: it takes the plain versions too, which is what
the reference traces (``use_pallas=False``) and what ``models/tracing.py``
captures.  There is no fallback between the two: a failed build or launch
raises, and a CUDA tensor never takes the plain path.  The kernels have no
backward, so a CUDA call that autograd would differentiate raises (the
models' losses differentiate through the plain versions, on the CPU or
abstractly).  The configs' ``use_pallas`` is not consulted.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention as flash_attention_kernel
from .ssd import ssd as ssd_kernel
from .wkv6 import wkv6 as wkv6_kernel


def _plain(*tensors: torch.Tensor) -> bool:
    """True when the tensors take the plain version (all on the CPU or all
    ``meta``), False when they take the kernel (all on CUDA); raises on
    mixed devices, on any other device, and on CUDA tensors that autograd
    would differentiate."""
    types = {t.device.type for t in tensors}
    if len(types) != 1 or types - {"cpu", "cuda", "meta"}:
        raise ValueError(f"inputs must all be on the CPU, all on CUDA or "
                         f"all meta, got {sorted(types)}")
    if "cuda" not in types:
        return True
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the CUDA kernels have no backward: "
                           "differentiate through the plain versions (CPU "
                           "or meta tensors)")
    return False


def wkv6(r, k, v, w, u, state, *, chunk: int = 64):
    """RWKV6 WKV recurrence.  r,k,w: (B,H,T,K); v: (B,H,T,V); u: (H,K);
    state: (B,H,K,V), all float32.  Returns (y (B,H,T,V), final state)."""
    args = (r, k, v, w, u, state)
    if _plain(*args):
        return ref.wkv6_chunked_ref(*args, chunk=chunk)
    return wkv6_kernel(*(a.contiguous() for a in args), chunk=chunk)


def ssd(x, dt, A, Bm, Cm, D, state, *, chunk: int = 64):
    """Mamba2 SSD recurrence.  x: (B,H,T,P); dt: (B,H,T); A: (H,);
    Bm,Cm: (B,G,T,N); D: (H,); state: (B,H,P,N), all float32."""
    args = (x, dt, A, Bm, Cm, D, state)
    if _plain(*args):
        return ref.ssd_chunked_ref(*args, chunk=chunk)
    return ssd_kernel(*(a.contiguous() for a in args), chunk=chunk)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 128, block_kv: int = 128):
    """Attention from position 0.  q: (B,T,H,hd); k,v: (B,S,KV,hd) ->
    (B,T,H,hd) in q's dtype.  On the CPU (or meta) ``attention_ref`` with
    KV chunks of ``block_kv`` (what the reference's ``ops.flash_attention``
    runs without Pallas; the models pass their ``attn_chunk_kv``, as the
    reference's ``attention_ref`` calls do); on the card the CUDA kernel,
    which reads the tensors with their strides."""
    if _plain(q, k, v):
        # imported here: the models package imports this module
        from ..models.layers import attention_ref
        return attention_ref(q, k, v, causal=causal, window=window,
                             chunk_kv=block_kv)
    return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                  block_q=block_q, block_kv=block_kv)
