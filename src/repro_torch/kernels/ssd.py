"""Mamba2 SSD recurrence: the wrapper of the CUDA kernel (K3).

Replaces the TPU kernel ``src/repro/kernels/mamba2_ssd.py::ssd_pallas``.
The CUDA source is ``csrc/ssd.cu``: for T >= 64 (at N = 128, T >= 32),
one CTA per (batch, head, tile of 64 state rows) runs the chunked
(state-space dual) form over blocks of 64 tokens (32 at N = 128), its four
block products on the tensor cores in 3xTF32; for shorter T (every decode
step) a token-step kernel of the same source runs the recurrence with the
state tile in registers (see the note there on what bounds each).  Neither copies the TPU kernel's ``exp(-cs)``
split, which overflows float32 at the configs' chunk of 256: every
exponent is a non-positive decay difference.

``ssd(x, dt, A, Bm, Cm, D, state)`` takes float32, contiguous CUDA
tensors — x: (B,H,T,P); dt: (B,H,T); A, D: (H,); Bm, Cm: (B,G,T,N);
state: (B,H,P,N), with N in {8, 16, 32, 64, 128}, P <= 256 and H a
multiple of G — and returns (y (B,H,T,P), final state).  It launches one
grid per call, on PyTorch's current stream, and raises on anything else.
The plain versions are ``ref.ssd_chunked_ref`` (what ``ops.ssd`` runs for
tensors on the CPU), ``ref.ssd_blocked_ref`` (the kernel's blocking) and
``ref.ssd_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import (HEAD_SIZES, MAX_WIDTH, CudaLibrary,
                         SingleLaunchKernel, aligned16, check_inputs)

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int32] * 6 + [ctypes.c_void_p]


class SsdKernel(SingleLaunchKernel):
    def __init__(self) -> None:
        super().__init__(CudaLibrary(
            "ssd", {"ssd_forward": (_ARGTYPES, ctypes.c_int)}),
            "ssd_forward")

    def __call__(self, x, dt, A, Bm, Cm, D, state, chunk: int = 64):
        """One launch of the kernel.  ``chunk`` is accepted for the plain
        version's sake and ignored: the kernel's blocks are 64 tokens (32
        at N = 128)."""
        B, H, T, P = x.shape
        G, N = Bm.shape[1], Bm.shape[-1]
        dev = check_inputs(
            "ssd", dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, D=D, state=state),
            dict(x=(B, H, T, P), dt=(B, H, T), A=(H,), Bm=(B, G, T, N),
                 Cm=(B, G, T, N), D=(H,), state=(B, H, P, N)))
        if N not in HEAD_SIZES:
            raise ValueError(f"ssd: N={N}; the kernel takes N in {HEAD_SIZES}")
        if not 1 <= P <= MAX_WIDTH:
            raise ValueError(f"ssd: P={P}; the kernel takes 1..{MAX_WIDTH}")
        if G < 1 or H % G:
            raise ValueError(f"ssd: H={H} heads are not a multiple of G={G} "
                             f"groups")
        y = torch.empty((B, H, T, P), dtype=torch.float32, device=dev)
        sf = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
        if B * H == 0:
            return y, sf
        x, Bm, Cm, state = map(aligned16, (x, Bm, Cm, state))
        self._launch(dev, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
                     state.data_ptr(), y.data_ptr(), sf.data_ptr(),
                     B, H, G, T, P, N)
        return y, sf


#: The one instance the models dispatch through (``ops.ssd``).
ssd = SsdKernel()
