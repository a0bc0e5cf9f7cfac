"""Build and load the port's CUDA sources.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with ``ctypes``.  The library lands in ``build/`` at the root of the
checkout under a name that carries the hash of the source and the flags,
so an edited source is never served by a stale library.  Nothing is built
when a module is imported: a kernel's wrapper builds its library at first
use, and ``build_all`` builds several at once (one ``nvcc`` each, all
started together).

Every C entry point returns a CUDA error code (0 is success); each
library also exports ``<name>_error_string(int)``, and ``check`` turns a
nonzero code into a ``RuntimeError``.

A source may include headers (``#include "x.cuh"``) from its own directory
or ``csrc/``; their contents are part of the hash.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
#: flags every source is built with: Hopper with its architecture-specific
#: features, optimised, position-independent, ptxas's register report, and
#: ``csrc/`` on the include path (so a copy of a source elsewhere finds the
#: shared headers).  No fast-math anywhere (IEEE division, square root and
#: denormals).
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(CSRC))


#: the state widths the recurrence kernels are instantiated for (K of WKV6,
#: N of SSD) and the most state columns they take (V of WKV6, P of SSD)
HEAD_SIZES = (8, 16, 32, 64, 128)
MAX_WIDTH = 256


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "CUDA kernels cannot be built")


Signature = Tuple[Sequence, object]


class CudaLibrary:
    """One ``csrc/<name>.cu`` source, built once per process and hash.

    ``functions`` maps each exported C function to its ``(argtypes,
    restype)``.  ``build_log`` keeps what ``nvcc -Xptxas -v`` printed the
    last time this process compiled the source (empty when the library
    was already on disk)."""

    def __init__(self, name: str, functions: Dict[str, Signature],
                 extra_flags: Sequence[str] = ()) -> None:
        self.name = name
        self.src = CSRC / f"{name}.cu"
        self.flags = tuple(BASE_FLAGS) + tuple(extra_flags)
        self.functions = dict(functions)
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def build(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            headers = {*self.src.parent.glob("*.cuh"), *CSRC.glob("*.cuh")}
            src = self.src.read_bytes() + b"".join(
                h.read_bytes() for h in sorted(headers))
            tag = hashlib.sha256(src + " ".join(self.flags).encode()
                                 ).hexdigest()[:12]
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            lib_path = BUILD_DIR / f"lib{self.name}-{tag}.so"
            if not lib_path.exists():
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    res = subprocess.run(
                        [nvcc(), *self.flags, "-o", tmp, str(self.src)],
                        capture_output=True, text=True)
                    self.build_log = res.stdout + res.stderr
                    if res.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed on {self.src.name} "
                            f"({res.returncode}):\n{self.build_log}")
                    os.replace(tmp, lib_path)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(str(lib_path))
            for fname, (argtypes, restype) in self.functions.items():
                fn = getattr(lib, fname)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            err_fn = getattr(lib, f"{self.name}_error_string")
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            self._lib = lib
            return lib

    def check(self, err: int, what: str) -> None:
        """Raise if a C entry point returned a nonzero CUDA error."""
        if err != 0:
            msg = getattr(self._lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{what} failed: {msg} (cudaError {err})")


def build_all(libs: Iterable[CudaLibrary]) -> None:
    """Build several libraries at once: one ``nvcc`` process each, all
    started together.  The first failure raises."""
    libs = list(libs)
    with ThreadPoolExecutor(max_workers=max(len(libs), 1)) as pool:
        for fut in [pool.submit(lib.build) for lib in libs]:
            fut.result()


class KernelWrapper:
    """What every kernel wrapper of the port has: its library and its
    ``launches`` and ``calls`` counts, plain integers that only the
    wrapper's launch adds to."""

    def __init__(self, lib: CudaLibrary) -> None:
        self.lib = lib
        self.launches = 0
        self.calls = 0

    def reset_counts(self) -> None:
        self.launches = 0
        self.calls = 0

    def build(self) -> ctypes.CDLL:
        """Compile the source (once per source hash) and load it."""
        return self.lib.build()

    @property
    def build_log(self) -> str:
        """What ``nvcc -Xptxas -v`` printed when this process built it."""
        return self.lib.build_log


class SingleLaunchKernel(KernelWrapper):
    """A wrapper whose every call launches one grid, on PyTorch's current
    stream."""

    def __init__(self, lib: CudaLibrary, entry: str) -> None:
        super().__init__(lib)
        self.entry = entry
        self._fn = None

    def _launch(self, device, *args) -> None:
        """Call the C entry point with ``args`` and the current stream of
        ``device``; raise on a nonzero CUDA error."""
        fn = self._fn
        if fn is None:
            fn = self._fn = getattr(self.build(), self.entry)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        self.calls += 1
        self.launches += 1
        self.lib.check(err, f"{self.entry} launch")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its data starts on a 16-byte boundary (the kernels'
    16-byte loads need it), else a fresh copy, which does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_inputs(name: str, tensors: dict, shapes: dict) -> torch.device:
    """Raise unless every tensor is a contiguous float32 CUDA tensor on one
    device with the shape ``shapes`` gives it.  Returns the device."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: every input must be on one CUDA device, "
                         f"got {sorted(map(str, devs))}")
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shapes[key])}")
    return next(iter(devs))
