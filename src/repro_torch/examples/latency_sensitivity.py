"""Latency-sensitivity analysis of the paper's workloads, the port's twin
of the JAX package's ``examples/latency_sensitivity.py``.

Reproduces the analysis flow of §4-5 end to end:
  * rank PolyBench kernels by lambda and by simulated latency sweeps;
  * HPCG / LULESH cache studies;
  * (--hlo) per-mesh-axis collective lambda of a compiled sharded step —
    the multi-pod extension (how sensitive is a training step to added
    fabric latency on each mesh axis?).  The port compiles no HLO: it reads
    the reference's compiled texts recorded under ``configs/hlo/`` (the
    train step of a (2, 4) mesh and qwen3-0.6b's train step on the
    256-chip pod).

The depths run the level kernel (K1) on the card, or its plain version
with ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.examples.latency_sensitivity
      [--hlo] [--device cpu] [--reduced]
"""
from __future__ import annotations

import argparse
import gzip
from pathlib import Path

from ..apps import hpcg, polybench
from ..core import (CostModelParams, collective_sensitivity, lambda_abs,
                    latency_sweep, make_cache, report)
from ._device import add_device_arg, on_device

HLO = Path(__file__).resolve().parents[1] / "configs" / "hlo"
#: (fixture, its mesh axes) of --hlo
HLO_STEPS = (("train.hlo.gz", [("data", 2), ("model", 4)]),
             ("dryrun/qwen3-0.6b__train_4k__pod.hlo.gz",
              [("data", 16), ("model", 16)]))


def polybench_ranking(N: int, emit) -> list:
    emit("== PolyBench lambda ranking (m=4) ==")
    rows = []
    for name in polybench.PAPER_15:
        lay = polybench.trace_kernel(name, N).mem_layers()
        rows.append((lambda_abs(lay.W, lay.D, 4), name, lay.W, lay.D))
    rows.sort(reverse=True)
    for lam, name, W, D in rows:
        emit(f"  {name:10s} lambda={lam:9.1f}  W={W:7d} D={D:4d}")
    return rows


def hpcg_cache_study(n: int, iters: int, emit) -> list:
    emit("\n== HPCG: does a cache buy latency tolerance? ==")
    rows = []
    for cs in (0, 32 * 1024):
        g, _ = hpcg.trace_cg(n=n, iters=iters, cache=make_cache(cs))
        r = report(g, CostModelParams(m=4, alpha=200.0))
        sweep = latency_sweep(g, [50, 150, 300], m=4)
        rows.append((cs, r.lam, list(sweep)))
        emit(f"  cache={cs:6d}: lambda={r.lam:9.0f}  "
             f"sim(50->300ns): {sweep[0]:.2e} -> {sweep[-1]:.2e} "
             f"({sweep[-1] / sweep[0]:.2f}x)")
    return rows


def hlo_sensitivity(emit) -> dict:
    emit("\n== compiled-step per-axis collective lambda (multi-pod) ==")
    out = {}
    for name, axes in HLO_STEPS:
        text = gzip.decompress((HLO / name).read_bytes()).decode()
        sens = collective_sensitivity(text, axes)
        emit(f"  {name} on {dict(axes)}:")
        for ax, s in sens["per_axis"].items():
            emit(f"    axis={ax:8s} W={s.W:5.0f} D={s.D:5.0f} "
                 f"lambda={s.lam:7.1f} -> {s.lam_seconds * 1e6:.1f} us lost "
                 "per step per us of added fabric latency")
        out[name] = sens["per_axis"]
    return out


def main(argv=None, emit=print) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hlo", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="PolyBench at N=6 and HPCG at 4^3 x 2 iterations")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    out = {}
    with on_device(args.device):
        out["polybench"] = polybench_ranking(6 if args.reduced else 16, emit)
        out["hpcg"] = hpcg_cache_study(*((4, 2) if args.reduced else (8, 4)),
                                       emit)
        if args.hlo:
            out["hlo"] = hlo_sensitivity(emit)
    return out


if __name__ == "__main__":
    main()
