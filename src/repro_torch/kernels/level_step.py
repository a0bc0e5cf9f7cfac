"""The batched (max,+) level kernel: CUDA wrapper, plain version and build.

Replaces the TPU kernel ``src/repro/core/backend.py::_pallas_level_step``
(with its level loop ``_accumulate_jax`` and the padding step
``_jax_padded``).  The CUDA source is ``csrc/level_step.cu``; it reads the
level CSR directly, so nothing is padded.

* ``level_step(lv, F, clamp, R_out)`` runs the whole level recurrence in
  place on ``F``.  A tensor on the card goes to the CUDA kernel (float32 or
  float64) or the call raises; a tensor on the CPU takes the plain version.
  There is no fallback from one to the other.
* ``level_step_plain`` is the plain PyTorch version: a port of the
  reference numpy kernel (``_accumulate_numpy``) in torch ops, one Python
  iteration per level.  The CPU tests use it, and ``chip_smoke.py`` holds
  the kernel against it on the card.
* ``level_step.launches`` counts the grids the kernel launched (one per
  non-empty level per call) and ``level_step.calls`` the calls that
  reached the kernel.  Both are plain integers; nothing else adds to them.

What bounds the kernel: the number of dependent levels, not bytes or
operations (see the note in the CUDA source).

The shared library is built at first use with ``nvcc`` into ``build/`` at
the root of the checkout, under a name that carries the source's hash, so
an edited source is never served by a stale library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "level_step.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "level kernel cannot be built")


def _np_max(a: torch.Tensor, b) -> torch.Tensor:
    """``np.maximum`` exactly: NaN in either operand wins, and ``b`` is
    returned where the two compare equal (``torch.maximum`` keeps ``a``'s
    signed zero instead)."""
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return torch.where((a > b) | torch.isnan(a), a, b)


def level_step_plain(lv, F: torch.Tensor, clamp: bool = True,
                     R_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of the level kernel, in place on ``F``.

    A line-by-line port of the reference numpy kernel: per level, a
    segmented max by offset stepping over the runs of equal destination,
    the ready times into ``R_out``, the slot-chain fold, the clamp and one
    add; then the queue-only vertices.  Works on any device."""
    dv = lv.device_arrays(F.device)
    rptr = dv.run_ptr_host.tolist()
    maxlens = lv.level_maxlens()
    src, rdst, rstart, rlens = dv.esrc, dv.run_dst, dv.run_starts, dv.run_lens
    qp = dv.qpred
    qptr = dv.qonly_ptr_host.tolist() if dv.qonly_ptr_host is not None \
        else None
    for lvl in range(1, lv.n_levels):
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


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int32, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int64)]


class LevelStep:
    """The CUDA level kernel behind one callable, with its launch counts
    and its build."""

    def __init__(self) -> None:
        self.launches = 0
        self.calls = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def reset_counts(self) -> None:
        self.launches = 0
        self.calls = 0

    # --------------------------------------------------------------- build
    def build(self) -> ctypes.CDLL:
        """Compile ``csrc/level_step.cu`` (once per source hash) and load
        it.  ``build_log`` keeps what ``nvcc -Xptxas -v`` printed."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            src = _SRC.read_bytes()
            tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                                 ).hexdigest()[:12]
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            lib_path = BUILD_DIR / f"liblevel_step-{tag}.so"
            if not lib_path.exists():
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    res = subprocess.run(
                        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SRC)],
                        capture_output=True, text=True)
                    self.build_log = res.stdout + res.stderr
                    if res.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed ({res.returncode}):\n"
                            f"{self.build_log}")
                    os.replace(tmp, lib_path)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(str(lib_path))
            for name in ("level_step_f32", "level_step_f64"):
                fn = getattr(lib, name)
                fn.argtypes = _ARGTYPES
                fn.restype = ctypes.c_int
            lib.level_step_error_string.argtypes = [ctypes.c_int]
            lib.level_step_error_string.restype = ctypes.c_char_p
            self._lib = lib
            return lib

    # -------------------------------------------------------------- launch
    def __call__(self, lv, F: torch.Tensor, clamp: bool = True,
                 R_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run the level recurrence in place on ``F`` ((rows, k), or (n,)
        for one column) and return it.  CPU tensors take the plain
        version; CUDA tensors take the kernel."""
        if F.device.type == "cpu":
            return level_step_plain(lv, F, clamp=clamp, R_out=R_out)
        if F.device.type != "cuda":
            raise ValueError(f"level_step: unsupported device {F.device}")
        F2 = F.view(-1, 1) if F.ndim == 1 else F
        R2 = None
        if R_out is not None:
            R2 = R_out.view(-1, 1) if R_out.ndim == 1 else R_out
        self._check(lv, F2, R2)
        if F2.shape[1] == 0 or lv.n_levels < 2:
            return F
        fn_name = ("level_step_f32" if F2.dtype == torch.float32
                   else "level_step_f64")
        lib = self.build()
        dv = lv.device_arrays(F2.device)

        def ptr(t):
            return None if t is None else t.data_ptr()

        launched = ctypes.c_int64(0)
        with torch.cuda.device(F2.device):
            stream = torch.cuda.current_stream(F2.device).cuda_stream
            err = getattr(lib, fn_name)(
                ptr(dv.esrc), ptr(dv.run_dst), ptr(dv.run_starts),
                ptr(dv.run_lens), dv.run_ptr_host.ctypes.data, ptr(dv.qpred),
                ptr(dv.qonly_dst),
                (dv.qonly_ptr_host.ctypes.data
                 if dv.qonly_ptr_host is not None else None),
                int(lv.n_levels), F2.data_ptr(), ptr(R2), int(F2.shape[1]),
                int(bool(clamp)), stream, ctypes.byref(launched))
        self.calls += 1
        self.launches += int(launched.value)
        if err != 0:
            msg = lib.level_step_error_string(err).decode()
            raise RuntimeError(f"level_step kernel launch failed: {msg} "
                               f"(cudaError {err})")
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
