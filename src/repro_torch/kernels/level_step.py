"""The batched (max,+) level kernels: CUDA wrapper, plain version and build.

Replaces the TPU kernel ``src/repro/core/backend.py::_pallas_level_step``
(with its level loop ``_accumulate_jax`` and the padding step
``_jax_padded``).  The CUDA source is ``csrc/level_step.cu``; it reads the
level CSR directly, so nothing is padded.

* ``level_step(lv, F, clamp, R_out)`` runs the whole level recurrence in
  place on ``F``.  A tensor on the card goes to the CUDA kernels (float32
  or float64) or the call raises; a tensor on the CPU takes the plain
  version.  There is no fallback from one to the other.
* On the card the call follows ``lv.level_plan(narrow_width(k))``: each
  maximal stretch of narrow levels (runs plus queue-only vertices at most
  ``narrow_width(k)``) is one launch of the segment kernel, in which one
  CTA per tile of ``COLUMN_TILE`` sweep columns runs level after level with
  a barrier between them (the columns are independent longest-path
  problems); each wider level is one launch of the per-level kernel.
* ``level_step_plain`` is the plain PyTorch version: a port of the
  reference numpy kernel (``_accumulate_numpy``) in torch ops, one Python
  iteration per level, over all levels or one plan row's range.  The CPU
  tests use it, and ``chip_smoke.py`` holds the kernels against it on the
  card.
* ``level_step.launches`` counts the grids launched, ``level_step.levels``
  the non-empty dependent levels they ran and ``level_step.calls`` the
  calls that reached the kernels.  All are plain integers; nothing else
  adds to them.

What bounds the kernels: the number of dependent levels, not bytes or
operations (see the note in the CUDA source).

The shared library is built at first use by ``cuda_build.CudaLibrary``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .cuda_build import CudaLibrary, KernelWrapper


def _np_max(a: torch.Tensor, b) -> torch.Tensor:
    """``np.maximum`` exactly: NaN in either operand wins, and ``b`` is
    returned where the two compare equal (``torch.maximum`` keeps ``a``'s
    signed zero instead)."""
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return torch.where((a > b) | torch.isnan(a), a, b)


def level_step_plain(lv, F: torch.Tensor, clamp: bool = True,
                     R_out: Optional[torch.Tensor] = None,
                     levels: Optional[Tuple[int, int]] = None
                     ) -> torch.Tensor:
    """The plain PyTorch version of the level kernels, in place on ``F``.

    A line-by-line port of the reference numpy kernel: per level, a
    segmented max by offset stepping over the runs of equal destination,
    the ready times into ``R_out``, the slot-chain fold, the clamp and one
    add; then the queue-only vertices.  ``levels = (l0, l1)`` runs levels
    ``l0..l1-1`` only (default: all of ``1..n_levels-1``), as one row of
    the kernels' plan does.  Works on any device."""
    dv = lv.device_arrays(F.device)
    rptr = dv.run_ptr_host.tolist()
    maxlens = lv.level_maxlens()
    src, rdst, rstart, rlens = dv.esrc, dv.run_dst, dv.run_starts, dv.run_lens
    qp = dv.qpred
    qptr = dv.qonly_ptr_host.tolist() if dv.qonly_ptr_host is not None \
        else None
    for lvl in range(*(levels or (1, lv.n_levels))):
        r0, r1 = rptr[lvl], rptr[lvl + 1]
        if r0 != r1:
            d = rdst[r0:r1]
            starts = rstart[r0:r1]
            segmax = F[src[starts]]
            lens = rlens[r0:r1]
            for off in range(1, maxlens[lvl]):
                live = lens > off
                segmax[live] = _np_max(segmax[live], F[src[starts[live] + off]])
            if R_out is not None:
                R_out[d] = segmax
            if qp is not None:
                segmax = _np_max(segmax, F[qp[d]])
            if clamp:
                segmax = _np_max(segmax, 0.0)
            F[d] = segmax + F[d]
        if qptr is not None:
            q0, q1 = qptr[lvl], qptr[lvl + 1]
            if q0 != q1:
                d = dv.qonly_dst[q0:q1]
                Fq = F[qp[d]]
                if clamp:
                    Fq = _np_max(Fq, 0.0)
                F[d] = F[d] + Fq
    return F


#: The segment kernel's shape, handed to nvcc: threads per CTA, and the
#: most sweep columns one CTA owns.
SEGMENT_THREADS = 512
COLUMN_TILE = 8
#: A level joins its neighbours in one launch when its (run, column) pairs
#: take at most this many passes of one CTA's threads.  A pass costs about
#: one round of dependent gathers (~0.5-1 us); past four of them, spreading
#: the level over the card in a launch of its own (~4 us) is no slower.
SEGMENT_PASSES = 4


def narrow_width(k: int) -> int:
    """The widest level (runs plus queue-only vertices) that a segment
    takes, for ``k`` sweep columns."""
    return SEGMENT_THREADS * SEGMENT_PASSES // max(1, min(k, COLUMN_TILE))


_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int32, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int32, ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int64)]


class LevelStep(KernelWrapper):
    """The CUDA level kernels behind one callable, with their counts and
    their build.  ``levels`` counts the non-empty dependent levels the
    kernels ran (``launches`` the grids, ``calls`` the calls)."""

    def __init__(self) -> None:
        # -fmad=false: each finish is one IEEE add, never a fused one
        super().__init__(CudaLibrary(
            "level_step",
            {name: (_ARGTYPES, ctypes.c_int)
             for name in ("level_step_f32", "level_step_f64")},
            extra_flags=("-fmad=false",
                         f"-DLEVEL_STEP_SEG_THREADS={SEGMENT_THREADS}",
                         f"-DLEVEL_STEP_COL_TILE={COLUMN_TILE}")))
        self.levels = 0

    def reset_counts(self) -> None:
        super().reset_counts()
        self.levels = 0

    # -------------------------------------------------------------- launch
    def __call__(self, lv, F: torch.Tensor, clamp: bool = True,
                 R_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run the level recurrence in place on ``F`` ((rows, k), or (n,)
        for one column) and return it.  CPU tensors take the plain
        version; CUDA tensors take the kernels."""
        if F.device.type == "cpu":
            return level_step_plain(lv, F, clamp=clamp, R_out=R_out)
        if F.device.type != "cuda":
            raise ValueError(f"level_step: unsupported device {F.device}")
        F2 = F.view(-1, 1) if F.ndim == 1 else F
        R2 = None
        if R_out is not None:
            R2 = R_out.view(-1, 1) if R_out.ndim == 1 else R_out
        self._check(lv, F2, R2)
        k = int(F2.shape[1])
        if k == 0 or lv.n_levels < 2:
            return F
        fn_name = ("level_step_f32" if F2.dtype == torch.float32
                   else "level_step_f64")
        lib = self.build()
        dv = lv.device_arrays(F2.device)
        plan = lv.level_plan(narrow_width(k))

        def ptr(t):
            return None if t is None else t.data_ptr()

        launched = ctypes.c_int64(0)
        with torch.cuda.device(F2.device):
            stream = torch.cuda.current_stream(F2.device).cuda_stream
            err = getattr(lib, fn_name)(
                ptr(dv.esrc), ptr(dv.run_dst), ptr(dv.run_starts),
                ptr(dv.run_lens), ptr(dv.run_src0), ptr(dv.run_qp),
                ptr(dv.qonly_dst), ptr(dv.qonly_qp),
                ptr(dv.run_ptr), ptr(dv.qonly_ptr),
                dv.run_ptr_host.ctypes.data,
                (dv.qonly_ptr_host.ctypes.data
                 if dv.qonly_ptr_host is not None else None),
                plan.ctypes.data, len(plan), F2.data_ptr(), ptr(R2), k,
                int(bool(clamp)), stream, ctypes.byref(launched))
        self.calls += 1
        self.launches += int(launched.value)
        self.levels += int(plan[:, 3].sum())
        self.lib.check(err, "level_step kernel launch")
        return F

    @staticmethod
    def _check(lv, F: torch.Tensor, R: Optional[torch.Tensor]) -> None:
        if F.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"level_step takes float32 or float64, got "
                             f"{F.dtype}")
        if F.ndim != 2 or not F.is_contiguous():
            raise ValueError("level_step needs a contiguous (rows, k) "
                             "matrix")
        need = lv.n + (1 if lv.qpred is not None else 0)
        if F.shape[0] < need:
            raise ValueError(f"level_step needs at least {need} rows, got "
                             f"{F.shape[0]}")
        if R is not None and (R.shape != F.shape or R.dtype != F.dtype or
                              R.device != F.device or
                              not R.is_contiguous()):
            raise ValueError("R_out must match F in shape, dtype, device "
                             "and be contiguous")


#: The one instance the engine dispatches through.
level_step = LevelStep()
