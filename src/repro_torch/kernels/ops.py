"""Dispatch of the model zoo's kernels, by the device of the tensors: a
CUDA tensor goes to the hand-written kernel (``wkv6.py``, ``ssd.py``,
``flash_attention.py``), a CPU tensor to what the reference package's
models run on the CPU (the chunked recurrences of ``ref.py``,
``models.layers.attention_ref``).  A ``meta`` tensor carries no data, so
no kernel can run on it: it takes the plain versions too, which is what
the reference traces (``use_pallas=False``) and what ``models/tracing.py``
captures.  There is no fallback between the two: a failed build or launch
raises, and a CUDA tensor never takes the plain path silently.  The
configs' ``use_pallas`` is not consulted.

The kernels compute forward only.  A CUDA call that autograd would
differentiate raises, except inside ``differentiable()``: the training
route, which ``train.train_loop.make_train_step`` enters and nothing else
does.  Inside it every call takes the plain version on any device —
``attention_ref`` with the model's ``attn_chunk_kv``,
``ref.wkv6_chunked_ref``, ``ref.ssd_chunked_ref`` — and autograd
differentiates it.  That is the reference's own training math: its train
step differentiates those same functions and runs no Pallas kernel
(``use_pallas`` is off in every config, and it has no backward kernel).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from . import ref
from .flash_attention import flash_attention as flash_attention_kernel
from .ssd import ssd as ssd_kernel
from .wkv6 import wkv6 as wkv6_kernel


_route = threading.local()


@contextmanager
def differentiable():
    """The training route: inside the block every call takes the plain
    version, CUDA tensors included, so that autograd can differentiate
    it (the reference's train step differentiates the same functions).
    Only ``make_train_step`` enters it."""
    prev = getattr(_route, "plain", False)
    _route.plain = True
    try:
        yield
    finally:
        _route.plain = prev


def training_route() -> bool:
    """True inside ``differentiable()``."""
    return getattr(_route, "plain", False)


def _plain(*tensors: torch.Tensor) -> bool:
    """True when the tensors take the plain version (all on the CPU, all
    ``meta``, or inside ``differentiable()``), False when they take the
    kernel (all on CUDA); raises on mixed devices, on any other device,
    and, outside ``differentiable()``, on CUDA tensors that autograd would
    differentiate."""
    types = {t.device.type for t in tensors}
    if len(types) != 1 or types - {"cpu", "cuda", "meta"}:
        raise ValueError(f"inputs must all be on the CPU, all on CUDA or "
                         f"all meta, got {sorted(types)}")
    if "cuda" not in types or training_route():
        return True
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the CUDA kernels have no backward: "
                           "differentiate inside ops.differentiable() (the "
                           "training route: the plain versions) or on CPU "
                           "or meta tensors")
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
