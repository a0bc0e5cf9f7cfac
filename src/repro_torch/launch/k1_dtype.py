"""Where a float32 level pass pays on the card: float32 against float64.

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.k1_dtype [--out FILE]

Times K1 (``backend._pass``) in float32 and in float64 by CUDA events,
and the whole dispatch on the host clock (``backend.replay_accumulate``
under the explicit float32 policy: pre-screen, casts, float32 pass,
certificate and copies, against the explicit float64 policy: one pass),
against the sweep's column count ``k`` on two kinds of plan:

* HPCG's replay plan: the CG trace on a 16^3 grid for 6 iterations, its
  schedule recorded at m = 4 with 8 ALU slots, the sweep's alphas;
* wide, shallow synthetic plans: ``levels`` levels of ``width`` vertices,
  each vertex with ``deg`` random predecessors on the level below, integer
  bases that every column certifies.

Every shape fits the replay budget (``rows * k * REPLAY_BYTES_PER_CELL <=
REPLAY_MEM_BUDGET``).  The two dtypes run in turns, each time on a fresh
copy of the bases; a row's times are medians.  Each row gives the float64
bytes a dependent level moves (``f64_level_bytes``), the ratios
float32 / float64 of the passes and of the whole dispatch, and whether the
two dispatches gave the same bits, as one JSON line; all rows are written
to ``--out``.  This is the measurement behind the card's default in
``backend.replay_accumulate`` (one float64 pass, no certificate); nothing
here is on the main path.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..core import backend as bk
from ..core.plan import REPLAY_BYTES_PER_CELL, REPLAY_MEM_BUDGET

HPCG_N, HPCG_ITERS = 16, 6
HPCG_KS = (1, 2, 4, 6, 9)
SWEEP_ALPHAS = (50.0, 75.0, 100.0, 125.0, 150.0, 175.0, 200.0, 225.0,
                250.0, 275.0, 300.0)
WIDE_LEVELS = (2, 3, 12)
WIDE_DEGS = (4, 32, 128)
WIDE_WIDTHS = (1 << 10, 1 << 13, 1 << 16, 1 << 18, 1 << 20)
WIDE_KS = (1, 8, 64, 512)
#: the synthetic plans' edges are built on the host: keep them bounded
MAX_EDGES = 1 << 25
#: host seconds a row's repetitions aim at
ROW_SECONDS = 0.6


def fits(rows: int, k: int) -> bool:
    return rows * k * REPLAY_BYTES_PER_CELL <= REPLAY_MEM_BUDGET


def f64_level_bytes(lv: bk.LevelCSR, rows: int, k: int) -> float:
    """The float64 bytes one dependent level of a ``(rows, k)`` pass over
    ``lv`` moves on average: ``8 k (rows + edges + queue edges) /
    n_levels``."""
    queue = 0 if lv.qpred is None else int(np.count_nonzero(lv.qpred < lv.n))
    return 8.0 * k * (rows + len(lv.esrc) + queue) / max(lv.n_levels, 1)


def wide_plan(levels: int, width: int, deg: int, seed: int = 0
              ) -> bk.LevelCSR:
    """``levels`` levels of ``width`` vertices; each vertex past the first
    level takes ``deg`` random predecessors on the level below."""
    rng = np.random.default_rng(seed)
    n = levels * width
    dst = np.repeat(np.arange(width, n, dtype=np.int64), deg)
    src = (dst // width - 1) * width + rng.integers(0, width, len(dst))
    level = (np.arange(n) // width).astype(np.int32)
    return bk.build_level_partition(src.astype(np.int32),
                                    dst.astype(np.int32), level, n)


def hpcg_plan():
    """HPCG's replay plan, recorded at the sweep's first alpha."""
    from ..apps.hpcg import trace_cg
    from ..core import scheduler as S
    g = trace_cg(n=HPCG_N, iters=HPCG_ITERS, seed=0)[0]
    g._finalize()
    _, plan = S._record_plan(g, g._sim_lists(), 4, 8, SWEEP_ALPHAS[0], 1.0,
                             persist=False)
    return plan


def _pass_ms(lv, base: torch.Tensor, dtype) -> float:
    F = base.to(dtype, copy=True)
    R = torch.zeros_like(F)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    bk._pass(lv, F, False, R)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


def _path_ms(lv, base: torch.Tensor, quanta, dtype: str):
    F = base.clone()
    R = torch.zeros_like(F)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bk.replay_accumulate(lv, F, quanta, clamp=False, R_out=R,
                         backend="cuda", replay_dtype=dtype)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), F, R


def measure(label: str, lv, base: torch.Tensor, quanta) -> dict:
    rows, k = base.shape
    runs = {"pass32": [], "pass64": [], "path32": [], "path64": []}

    def one_round():
        runs["pass64"].append(_pass_ms(lv, base, torch.float64))
        runs["pass32"].append(_pass_ms(lv, base, torch.float32))
        c0 = bk.stats["certified_columns"]
        t32, F32, R32 = _path_ms(lv, base, quanta, "float32")
        cert = bk.stats["certified_columns"] - c0
        t64, F64, R64 = _path_ms(lv, base, quanta, "float64")
        runs["path32"].append(t32)
        runs["path64"].append(t64)
        return cert, torch.equal(F32, F64) and torch.equal(R32, R64)

    one_round()                                   # warm-up
    for v in runs.values():
        v.clear()
    t0 = time.perf_counter()
    cert, same = one_round()
    per = time.perf_counter() - t0
    for _ in range(max(2, min(20, int(ROW_SECONDS / max(per, 1e-6))))):
        c, s = one_round()
        same = same and s
    med = {k_: statistics.median(v) for k_, v in runs.items()}
    row = dict(plan=label, rows=rows, k=k, n_levels=lv.n_levels,
               edges=len(lv.esrc), reps=len(runs["pass32"]),
               f64_level_bytes=f64_level_bytes(lv, rows, k),
               certified=cert, same_bits=bool(same),
               **{f"{k_}_ms": v for k_, v in med.items()},
               pass_ratio=med["pass32"] / med["pass64"],
               path_ratio=med["path32"] / med["path64"])
    print(json.dumps(row), flush=True)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/k1_dtype.json")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, torch.__version__, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    out = []

    t0 = time.perf_counter()
    plan = hpcg_plan()
    print(f"hpcg plan: {plan.n} rows, {plan.lv.n_levels} levels, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    is_mem = torch.from_numpy(np.asarray(plan.is_mem_topo, bool)).to(dev)
    for k in HPCG_KS:
        if not fits(plan.n + 1, k):
            continue
        alphas = np.resize(np.array(SWEEP_ALPHAS), k)
        a = torch.from_numpy(alphas).to(dev)
        base = torch.empty((plan.n + 1, k), dtype=torch.float64, device=dev)
        base[:-1] = torch.where(is_mem[:, None], a[None, :], 1.0)
        base[-1] = 0.0
        out.append(measure("hpcg-16x6", plan.lv, base,
                           bk.column_quanta(alphas, 1.0)))
    del plan, is_mem

    for levels in WIDE_LEVELS:
        for deg in WIDE_DEGS:
            for width in WIDE_WIDTHS:
                n = levels * width
                if (levels - 1) * width * deg > MAX_EDGES:
                    continue
                ks = [k for k in WIDE_KS if fits(n, k)]
                if not ks:
                    continue
                lv = wide_plan(levels, width, deg)
                for k in ks:
                    base = torch.randint(1, 301, (n, k), generator=gen,
                                         device=dev, dtype=torch.float64)
                    out.append(measure(f"wide L={levels} W={width} D={deg}",
                                       lv, base, np.ones(k)))
                del lv
                torch.cuda.empty_cache()
    summary = {"card": card, "torch": torch.__version__, "rows": out}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(summary, indent=1))
    print(f"{len(out)} rows written to {args.out}")


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("k1_dtype: no CUDA device")
    main()
