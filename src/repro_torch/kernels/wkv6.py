"""RWKV6 WKV recurrence: the wrapper of the CUDA kernel (K2).

Replaces the TPU kernel ``src/repro/kernels/rwkv6_wkv.py::wkv6_pallas``.
The CUDA source is ``csrc/wkv6.cu``: for T >= 16, one CTA per (batch,
head, tile of 16 value columns) runs the chunked form over blocks of 16
tokens, the pairwise decayed scores on the CUDA cores and the block
products on the tensor cores in 3xTF32; for T < 16 (every decode step) a
token-step kernel of the same source runs the recurrence with the state
tile in registers (see the note there on what bounds each).  Neither
copies the TPU kernel's ``exp(-cs)`` split, which overflows float32 at the
configs' chunk of 256: every exponent is a non-positive decay difference.

``wkv6(r, k, v, w, u, state)`` takes float32, contiguous CUDA tensors —
r, k, w: (B,H,T,K); v: (B,H,T,V); u: (H,K); state: (B,H,K,V), with K in
{8, 16, 32, 64, 128} and V <= 256 — and returns (y (B,H,T,V), final
state).  It launches one grid per call, on PyTorch's current stream, and
raises on anything else.  The plain versions are ``ref.wkv6_chunked_ref``
(what ``ops.wkv6`` runs for tensors on the CPU), ``ref.wkv6_blocked_ref``
(the kernel's blocking) and ``ref.wkv6_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import (HEAD_SIZES, MAX_WIDTH, CudaLibrary,
                         SingleLaunchKernel, aligned16, check_inputs)

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int32] * 5 + [ctypes.c_void_p]


class Wkv6Kernel(SingleLaunchKernel):
    def __init__(self) -> None:
        super().__init__(CudaLibrary(
            "wkv6", {"wkv6_forward": (_ARGTYPES, ctypes.c_int)}),
            "wkv6_forward")

    def __call__(self, r, k, v, w, u, state, chunk: int = 64):
        """One launch of the kernel.  ``chunk`` is accepted for the plain
        version's sake and ignored: the kernel's blocks are 16 tokens."""
        B, H, T, K = r.shape
        V = v.shape[-1]
        dev = check_inputs("wkv6", dict(r=r, k=k, v=v, w=w, u=u, state=state),
                           dict(r=(B, H, T, K), k=(B, H, T, K),
                                v=(B, H, T, V), w=(B, H, T, K), u=(H, K),
                                state=(B, H, K, V)))
        if K not in HEAD_SIZES:
            raise ValueError(f"wkv6: K={K}; the kernel takes K in "
                             f"{HEAD_SIZES}")
        if not 1 <= V <= MAX_WIDTH:
            raise ValueError(f"wkv6: V={V}; the kernel takes 1..{MAX_WIDTH}")
        y = torch.empty((B, H, T, V), dtype=torch.float32, device=dev)
        sf = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
        if B * H == 0:
            return y, sf
        r, k, w, v, state = map(aligned16, (r, k, w, v, state))
        self._launch(dev, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                     w.data_ptr(), u.data_ptr(), state.data_ptr(),
                     y.data_ptr(), sf.data_ptr(), B, H, T, K, V)
        return y, sf


#: The one instance the models dispatch through (``ops.wkv6``).
wkv6 = Wkv6Kernel()
