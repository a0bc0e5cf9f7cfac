"""Blocked flash attention: the wrapper of the CUDA kernels (K4).

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention_pallas``.  The CUDA source is ``csrc/flash_attention.cu``,
with one kernel per dtype:

* bfloat16, what the served models call: the tensor cores
  (``mma.sync`` m16n8k16, bf16 in, float32 sums).  One CTA of 8 warps per
  (64 query rows, head, batch) holds its Q tile in registers and streams
  K and V tiles of 128 keys through a two-stage ``cp.async`` ring in shared
  memory; two warps share each 16 rows, half of each tile's keys each,
  with the row max exchanged so that both see the sequential running max.
  The online softmax state (m, l, acc) stays in float32 registers, and the
  probabilities are rounded to bf16 for the product with v (as
  ``models.layers.attention_ref`` rounds them), with l summed from the
  float32 ones.
* float32: the CUDA cores, four threads per query row, float32 throughout
  (what the float32 fixtures are held to within 1e-4).

Both compute the causal, window and ragged-edge masks in the kernel and
skip the tiles wholly outside every row's mask.  Bytes set the least time
for the work; the note in the source says what holds each kernel above it.

``flash_attention(q, k, v, causal=True, window=0)`` takes CUDA tensors of
one dtype, float32 or bfloat16 — q: (B,T,H,hd); k, v: (B,S,KV,hd) with H
a multiple of KV and hd a multiple of 8 up to 128 — read through their
strides, and returns o (B,T,H,hd) in q's dtype, contiguous.  It launches
one grid per call, on PyTorch's current stream, and raises on anything
else, including inputs with a query row that sees no key
(``ref.check_attention_domain``).  ``block_q`` and ``block_kv`` are
accepted for the plain version's sake and ignored: the kernels choose
their tiles.  The plain version is ``ref.flash_attention_plain``
(``round_p=True`` rounds the probabilities as the bf16 kernel does);
``ops.flash_attention`` runs ``models.layers.attention_ref`` for tensors
on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, SingleLaunchKernel
from .ref import check_attention_domain

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int32] * 6 +
             [ctypes.c_int64] * 12 + [ctypes.c_int32] * 2 +
             [ctypes.c_float, ctypes.c_int32, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def _check_inputs(q, k, v) -> None:
    """Raise unless q, k, v have the kernel's shapes and one of its dtypes
    (the device is checked at launch)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention: q, k, v must be 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, T, H, hd = q.shape
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    S, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"KV={KV}")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: hd={hd}; the kernel takes a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype of "
                         f"float32 and bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention: B={B}, H={H}; the grid takes "
                         f"at most 65535 of each")


class FlashAttentionKernel(SingleLaunchKernel):
    def __init__(self) -> None:
        super().__init__(CudaLibrary(
            "flash_attention",
            {"flash_attention_forward": (_ARGTYPES, ctypes.c_int)}),
            "flash_attention_forward")

    def __call__(self, q, k, v, *, causal: bool = True, window: int = 0,
                 block_q: int = 128, block_kv: int = 128):
        """One launch of the kernel (none when T is 0)."""
        _check_inputs(q, k, v)
        B, T, H, hd = q.shape
        S, KV = k.shape[1], k.shape[2]
        check_attention_domain(T, S, window)
        devs = {t.device for t in (q, k, v)}
        if len(devs) != 1 or next(iter(devs)).type != "cuda":
            raise ValueError(f"flash_attention: q, k, v must be on one CUDA "
                             f"device, got {sorted(map(str, devs))}")
        dev = q.device
        out = torch.empty((B, T, H, hd), dtype=q.dtype, device=dev)
        if B * T * H == 0:
            return out
        self._launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), B, T, S, H, KV, hd, *q.stride(),
                     *k.stride(), *v.stride(), int(bool(causal)),
                     int(window), hd ** -0.5, _DTYPES[q.dtype])
        return out


#: The one instance the models dispatch through (``ops.flash_attention``).
flash_attention = FlashAttentionKernel()
