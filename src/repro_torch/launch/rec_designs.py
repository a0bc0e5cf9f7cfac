"""K2 (WKV6) and K3 (SSD): designs measured side by side on the card.

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.rec_designs \
      [--design LABEL=DIR ...]

Builds ``csrc/wkv6.cu`` and ``csrc/ssd.cu`` ("new") and, for each
``--design``, the ``wkv6.cu`` and ``ssd.cu`` in DIR (copies of another
design, such as an earlier commit's ``csrc/``, built under ``build/``),
and for each: prints ptxas's register, shared-memory and spill report,
holds it to the sequential plain version (``ref.wkv6_ref`` /
``ref.ssd_ref``) at every shape below (the largest |Δ| over the largest
|plain|, which must stay within 1e-5), and times it there by the kernel's
own device time under ``torch.profiler`` (the median of three windows of
20 launches, each after one warm-up), the designs in turns (given, new, new, given reversed) and averaged, and
by CUDA events over 100 launches (wrapper included).  The shapes: rwkv6-7b's and zamba2-7b's
heads (H=64, K=V=64; H=112, P=N=64, G=1) at the serve shapes (a decode
step of 4 slots, T=1; one 128-token prefill) and one 2048-token prompt.
Last, the card line and one JSON line of every time.  Nothing here is on
a served path: it is the measurement behind the kernels' design.
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

from ..kernels import ref
from ..kernels.cuda_build import BUILD_DIR
from ..kernels.ssd import SsdKernel
from ..kernels.wkv6 import Wkv6Kernel

#: kernel vs the sequential plain version, relative to the largest value
TOL = 1e-5
#: (label, batch, T)
SHAPES = (("T=1", 4, 1), ("T=128", 1, 128), ("T=2048", 1, 2048))
KERNELS = {"wkv6": Wkv6Kernel, "ssd": SsdKernel}


def inputs(name: str, B: int, T: int, seed: int):
    """Seeded float32 inputs on the card at the served heads' widths, in
    the ranges the models give them (decays in (0.45, 0.95); dt ~ 0.2
    softplus, A = -exp(0.3 N(0, 1))), and a nonzero initial state."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=g, device="cuda") * scale
    if name == "wkv6":
        H, K, V = 64, 64, 64
        return (rn(B, H, T, K), rn(B, H, T, K, scale=0.3), rn(B, H, T, V),
                torch.sigmoid(rn(B, H, T, K)) * 0.5 + 0.45,
                rn(H, K, scale=0.1), rn(B, H, K, V, scale=0.1))
    H, P, N = 112, 64, 64
    return (rn(B, H, T, P), 0.2 * torch.nn.functional.softplus(rn(B, H, T)),
            -torch.exp(0.3 * rn(H)), rn(B, 1, T, N, scale=0.4),
            rn(B, 1, T, N, scale=0.4), rn(H, scale=0.1),
            rn(B, H, P, N, scale=0.1))


def kernel_from(name: str, src_dir: Path, label: str):
    """The wrapper of ``name`` over ``src_dir/<name>.cu``, copied under
    ``build/`` with the headers beside it when it is not ``csrc/``."""
    kern = KERNELS[name]()
    if src_dir.resolve() != kern.lib.src.parent:
        out = BUILD_DIR / f"rec_designs_{label}"
        out.mkdir(parents=True, exist_ok=True)
        for f in [src_dir / f"{name}.cu", *src_dir.glob("*.cuh")]:
            shutil.copy(f, out / f.name)
        kern.lib.src = out / f"{name}.cu"
    return kern


def device_us(fn, reps: int = 20, windows: int = 3) -> float:
    """The CUDA kernels' device µs per call of ``fn`` under the profiler:
    the median over ``windows`` windows of ``reps`` calls (a window now and
    then records no kernel at all)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    per_call = []
    for _ in range(windows):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = sum(ev.self_device_time_total for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA)
        if dev > 0:
            per_call.append(dev / reps)
    return statistics.median(per_call) if per_call else float("nan")


def event_ms(fn, reps: int = 100) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` back-to-back calls
    after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--design", action="append", default=[],
                    metavar="LABEL=DIR",
                    help="a directory with another design's wkv6.cu and "
                         "ssd.cu (repeatable)")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    csrc = Path(__file__).resolve().parents[1] / "csrc"
    dirs = {label: Path(d) for label, d in
            (spec.split("=", 1) for spec in args.design)}
    dirs["new"] = csrc
    order = list(dirs) + list(dirs)[::-1]
    out, failed = {}, []
    for name in KERNELS:
        kerns = {label: kernel_from(name, d, label)
                 for label, d in dirs.items()}
        for label, kern in kerns.items():
            kern.build()
            print(f"{name} {label}:", *(ln.strip() for ln in
                                        kern.build_log.splitlines()
                                        if "registers" in ln
                                        or "spill" in ln), sep="\n  ",
                  flush=True)
        plain = ref.wkv6_ref if name == "wkv6" else ref.ssd_ref
        for label, B, T in SHAPES:
            a = inputs(name, B, T, seed=T)
            yp, Sp = plain(*a)
            errs = {}
            for design, kern in kerns.items():
                y, S = kern(*a)
                torch.cuda.synchronize()
                errs[design] = max(
                    ((y.double() - yp.double()).abs().max() /
                     yp.double().abs().max()).item(),
                    ((S.double() - Sp.double()).abs().max() /
                     Sp.double().abs().max()).item())
                if not errs[design] <= TOL:
                    failed.append(f"{name} {design} {label}: {errs[design]}")
            us = {d: [] for d in dirs}
            for design in order:
                us[design].append(device_us(lambda: kerns[design](*a)))
            row = {d: dict(device_us=sum(x) / len(x), device_us_runs=x,
                           ms=event_ms(lambda: kerns[d](*a)),
                           rel_err=errs[d]) for d, x in us.items()}
            out.setdefault(name, {})[label] = row
            print(f"{name} {label} (B={B} T={T}): " + ", ".join(
                f"{d} {r['device_us']:.2f} µs device, {r['ms']:.4f} ms "
                f"with the wrapper, |Δ| {r['rel_err']:.2e}"
                for d, r in row.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(json.dumps({"rec_designs": out}), flush=True)
    if failed:
        raise SystemExit("kernel vs sequential plain version beyond "
                         f"{TOL}: {failed}")


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("rec_designs: no CUDA device")
    main()
