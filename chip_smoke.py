#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Phases, each timed; any failure ends the run with a non-zero exit:

1. card   — the card's name and power limit (``nvidia-smi``).
2. build  — compile ``csrc/level_step.cu`` with nvcc and print ptxas's
            register/shared-memory report.
3. kernel — the CUDA level kernel against its plain PyTorch version on the
            card, float32 and float64, with and without slot chains, ready
            times and the clamp, on seeded random DAGs and on the real
            replay plan of PolyBench gemm (N=20, m=4, 8 ALU slots).  F and R
            must be bitwise equal.  Then timings: the kernel, the plain
            version and a per-level ``scatter_reduce`` yardstick on the
            main path's shapes.
4. main   — the paper runner (``repro_torch.launch.paper``) at the paper's
            sizes: PolyBench PAPER_15 at N=20 and HPCG 16^3 x 6 iterations
            (1.79M vertices) under the default float32 replay policy, then
            one latency sweep of the 32 kB HPCG trace with dirty alphas
            under a replay budget that splits it into chunks (float32
            columns demoted and rerun in float64 on the card), and the
            policy-dependent figures (10/11 and 12) again under the
            float64 policy.  Every printed line and every full-precision
            value must equal ``src/repro_torch/configs/paper_expected.json``
            (the JAX package's results), and the kernel's launch counter
            must grow in every figure.
5. report — the ``{"kernels": [...]}`` line, the card line, and last the
            ``{"ok": true, "device": {...}}`` line.

Usage: python3 chip_smoke.py   (from the root of a checkout, one card)
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside tensor cores


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def phase(name: str):
    """Context manager printing a phase's seconds."""
    class _P:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"== phase {name}", flush=True)
            return self

        def __exit__(self, *exc):
            if exc[0] is None:
                print(f"== phase {name} done in "
                      f"{time.perf_counter() - self.t0:.1f} s", flush=True)
            return False
    return _P()


# ------------------------------------------------------------- kernel phase

def random_dag(seed: int, n: int = 400, p_mem: float = 0.4):
    """A seeded random eDAG (edges u < v) with a mixed memory/ALU split."""
    import numpy as np
    from repro_torch.core.graph import EDag
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for v in range(1, n):
        k = int(rng.integers(0, min(v, 4) + 1))
        if k:
            us = rng.choice(v, size=k, replace=False)
            src.extend(us.tolist())
            dst.extend([v] * k)
    is_mem = rng.random(n) < p_mem
    return EDag.from_arrays(np.ones(n), is_mem, np.where(is_mem, 8.0, 0.0),
                            np.asarray(src, dtype=np.int64),
                            np.asarray(dst, dtype=np.int64))


def replay_plan(g, m: int, cs: int, alpha: float = 50.0):
    from repro_torch.core import scheduler as S
    g._finalize()
    _, plan = S._record_plan(g, g._sim_lists(), m, cs, alpha, 1.0,
                             persist=False)
    return plan


def bits_equal(a, b) -> bool:
    """Bitwise equal (signed zeros told apart), NaN where the other is
    NaN; a NaN's payload is not part of np.maximum's contract."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    return bool(torch.equal(a.masked_fill(nan, 0).contiguous().view(it),
                            b.masked_fill(nan, 0).contiguous().view(it)))


def abs_err(a, b) -> float:
    """Largest |a - b| over the entries where neither is NaN."""
    import torch
    d = (a.double() - b.double()).abs()
    d = d.masked_fill(torch.isnan(d), 0)
    return d.max().item() if d.numel() else 0.0


def base_matrix(lv, k: int, seed: int, dtype, slot: bool,
                dirty: bool = False):
    """Seeded base costs on the card, a zero sentinel row when slot chains
    are attached.  Clean: integer multiples of 1/4 (exact in both dtypes).
    Dirty: normal values of either sign (in float64 not representable in
    float32), some signed zeros, and one NaN."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    rows = lv.n + (1 if slot else 0)
    if dirty:
        base = rng.standard_normal((rows, k)) * 100.0
        zeros = rng.random((rows, k))
        base[zeros < 0.04] = -0.0
        base[zeros > 0.96] = 0.0
        base[rows // 3, k // 2] = np.nan
    else:
        base = rng.integers(1, 400, size=(rows, k)).astype(np.float64) / 4.0
    if slot:
        base[-1] = 0.0
    return torch.from_numpy(base).to("cuda", dtype)


def check_kernel(lv, k: int, seed: int, label: str):
    """Kernel vs plain version, bitwise, over dtype x R_out x clamp, on
    dirty bases.  Returns (cases, largest |kernel - plain| seen)."""
    import torch
    from repro_torch.kernels.level_step import level_step, level_step_plain
    slot = lv.qpred is not None
    n_cases, err = 0, 0.0
    for dtype in (torch.float32, torch.float64):
        for want_r in (False, True):
            for clamp in (False, True):
                base = base_matrix(lv, k, seed, dtype, slot, dirty=True)
                Fk, Fp = base.clone(), base.clone()
                Rk = torch.zeros_like(base) if want_r else None
                Rp = torch.zeros_like(base) if want_r else None
                level_step(lv, Fk, clamp=clamp, R_out=Rk)
                level_step_plain(lv, Fp, clamp=clamp, R_out=Rp)
                torch.cuda.synchronize()
                err = max(err, abs_err(Fk, Fp))
                if want_r:
                    err = max(err, abs_err(Rk, Rp))
                ok = bits_equal(Fk, Fp) and (not want_r or bits_equal(Rk, Rp))
                if not ok:
                    raise SystemExit(
                        f"kernel != plain on {label} dtype={dtype} "
                        f"R_out={want_r} clamp={clamp}: max|dF|="
                        f"{abs_err(Fk, Fp)}")
                n_cases += 1
    print(f"  {label}: n={lv.n} levels={lv.n_levels} slot_chains={slot} "
          f"k={k}: {n_cases} cases bitwise equal", flush=True)
    return n_cases, err


def library_version(lv, F, clamp: bool, R_out=None):
    """The same recurrence from stock PyTorch calls: per level, one
    ``scatter_reduce(amax)`` over the level's edges, then the slot fold,
    the clamp and the add.  A timing yardstick only."""
    import torch
    dv = lv.device_arrays(F.device)
    rptr = lv.run_ptr.tolist()
    eptr = lv.elevel_ptr.tolist()
    eseg = torch.repeat_interleave(
        torch.arange(len(lv.run_lens), device=F.device),
        dv.run_lens.long())
    qptr = lv.qonly_ptr.tolist() if lv.qonly_ptr is not None else None
    k = F.shape[1]
    for lvl in range(1, lv.n_levels):
        r0, r1 = rptr[lvl], rptr[lvl + 1]
        if r0 != r1:
            e0, e1 = eptr[lvl], eptr[lvl + 1]
            d = dv.run_dst[r0:r1]
            seg = torch.full((r1 - r0, k), float("-inf"), dtype=F.dtype,
                             device=F.device)
            idx = (eseg[e0:e1] - r0)[:, None].expand(-1, k)
            seg.scatter_reduce_(0, idx, F[dv.esrc[e0:e1]], reduce="amax")
            if R_out is not None:
                R_out[d] = seg
            if dv.qpred is not None:
                seg = torch.maximum(seg, F[dv.qpred[d]])
            if clamp:
                seg = seg.clamp_min(0)
            F[d] = seg + F[d]
        if qptr is not None and qptr[lvl] != qptr[lvl + 1]:
            d = dv.qonly_dst[qptr[lvl]:qptr[lvl + 1]]
            Fq = F[dv.qpred[d]]
            F[d] = F[d] + (Fq.clamp_min(0) if clamp else Fq)
    return F


def time_ms(fn, bases, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn(F)`` over fresh copies, CUDA events."""
    import torch
    for b in bases[:warmup]:
        fn(b.clone())
    copies = [b.clone() for b in bases]
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for F in copies:
        fn(F)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / len(copies)


def bound_ms(lv, k: int, itemsize: int, want_r: bool):
    """Least time for one call and what sets it: each CSR array read once,
    F read once and written once (R written once) over the card's memory
    rate, against the operations (one max per edge and column, one add
    per row and column) over the float32 rate."""
    n_edges, n_runs = len(lv.esrc), len(lv.run_lens)
    rows = lv.n + (1 if lv.qpred is not None else 0)
    csr = 4 * (n_edges + 3 * n_runs + len(lv.run_ptr))
    if lv.qpred is not None:
        csr += 4 * (len(lv.qpred) + (len(lv.qonly_dst)
                                     if lv.qonly_dst is not None else 0))
    data = itemsize * rows * k * (3 if want_r else 2)
    ops = (n_edges + rows) * k
    t_bytes = (csr + data) / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def measure(lv, k: int, dtype, clamp: bool, want_r: bool, reps: int,
            plain_reps: int) -> dict:
    import torch
    from repro_torch.kernels.level_step import level_step, level_step_plain
    slot = lv.qpred is not None
    bases = [base_matrix(lv, k, 7 + i, dtype, slot) for i in range(reps)]

    def R():
        return torch.zeros_like(bases[0]) if want_r else None

    launches0, calls0 = level_step.launches, level_step.calls
    ms = time_ms(lambda F: level_step(lv, F, clamp=clamp, R_out=R()), bases)
    per_call = ((level_step.launches - launches0) /
                max(level_step.calls - calls0, 1))
    plain = time_ms(lambda F: level_step_plain(lv, F, clamp=clamp,
                                               R_out=R()),
                    bases[:plain_reps], warmup=1)
    lib = time_ms(lambda F: library_version(lv, F, clamp, R()),
                  bases[:plain_reps], warmup=1)
    # the yardstick must compute the same function
    Fk, Fl = bases[0].clone(), bases[0].clone()
    level_step(lv, Fk, clamp=clamp)
    library_version(lv, Fl, clamp)
    torch.cuda.synchronize()
    err = (Fk.double() - Fl.double()).abs().max().item() if len(Fk) else 0.0
    if err != 0.0:
        raise SystemExit(f"scatter_reduce yardstick disagrees: {err}")
    itemsize = 4 if dtype == torch.float32 else 8
    bound, bound_by = bound_ms(lv, k, itemsize, want_r)
    return dict(ms=ms, ms_per_launch=ms / max(per_call, 1),
                launches_per_call=per_call, plain_ms=plain, library_ms=lib,
                bound_ms=bound, bound_by=bound_by,
                n=lv.n, levels=lv.n_levels, edges=int(len(lv.esrc)), k=k,
                dtype=str(dtype).replace("torch.", ""))


def profile_sweep(name: str = "gemm", N: int = 20) -> dict:
    """One fig 10/11 sweep (``sweep_report`` with the simulated points) of
    one PolyBench kernel under ``torch.profiler``: wall seconds, the
    device's busy seconds (sum of kernel times on the card) and the level
    kernel's share of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.apps import polybench
    from repro_torch.core import sweep_report
    from repro_torch.launch import paper
    g = polybench.trace_kernel(name, N)
    g._finalize()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep_report(g, paper.ANALYSIS.alpha_sweep, simulate_points=True,
                     compute_slots=paper.SIM_COMPUTE_SLOTS, use_cache=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = level = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        busy += dev_us
        if "level_kernel" in ev.key:
            level += dev_us
    if busy <= 0:
        return dict(kernel=f"{name} N={N}", wall_s=wall,
                    device_busy_s="not measured")
    return dict(kernel=f"{name} N={N}", wall_s=wall, device_busy_s=busy / 1e6,
                level_kernel_s=level / 1e6,
                device_idle_share=max(0.0, 1.0 - busy / 1e6 / wall))


# --------------------------------------------------------------- main phase

def same(a, b, path="") -> list:
    """Paths where two JSON-like values differ (floats compared exactly)."""
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return [f"{path}: keys {sorted(a)} != {sorted(b)}"]
        return [d for k in a for d in same(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{path}: length {len(a)} != {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in same(x, y, f"{path}[{i}]")]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def line_groups(lines, timed: bool) -> dict:
    """Runner lines grouped by figure: each CSV row (``name,derived``; a
    ``timed`` row's ``us_per_call`` column is dropped) followed by its
    indented detail lines."""
    from repro_torch.launch import paper
    by_row = {v: k for k, v in paper.ROW_NAMES.items()}
    groups, cur = {}, None
    for line in lines:
        if not line.startswith(" "):
            name, rest = line.split(",", 1)
            if timed:
                rest = rest.split(",", 1)[1]
            cur = by_row.get(name)
            line = f"{name},{rest}"
        if cur is not None:
            groups.setdefault(cur, []).append(line)
    return groups


def run_main_path(expected: dict, policy, figures, label: str) -> dict:
    """Drive the paper runner on the card, one figure at a time; hold
    every printed line and every value to the JAX package's.  Returns the
    kernel's launches per figure."""
    from repro_torch.core import backend as B
    from repro_torch.kernels.level_step import level_step
    from repro_torch.launch import paper
    want = line_groups(expected["lines"], timed=False)
    launches = {}
    api = paper.port_api()
    for name in figures:
        before = level_step.launches
        printed: list = []

        def emit(s):
            print(s, flush=True)
            printed.append(s)
        res = paper.run([name], api=api, policy=policy, emit=emit)
        launches[name] = level_step.launches - before
        if launches[name] <= 0:
            raise SystemExit(f"{label} {name}: the level kernel was not "
                             f"launched")
        got = line_groups(printed, timed=True)[name]
        if got != want[name]:
            raise SystemExit(f"{label} {name}: printed lines differ from "
                             f"the JAX package's:\n" + "\n".join(
                                 f"{a!r} != {b!r}"
                                 for a, b in zip(got, want[name]) if a != b))
        diff = same(json.loads(json.dumps(res[name])),
                    expected["results"][name], name)
        if diff:
            raise SystemExit(f"{label} {name} differs from the JAX "
                             f"package:\n" + "\n".join(diff[:20]))
    print(f"  {label}: launches per figure {launches}; stats "
          f"{dict(B.stats)}", flush=True)
    return launches


def run_dirty_sweep(spec: dict) -> dict:
    """``latency_sweep`` of the JAX package's dirty sweep (HPCG, 32 kB
    cache) on the card under the float32 policy, with a replay budget of
    two columns per chunk: the makespans must equal the recorded ones bit
    for bit, the budget must split the sweep, and columns must be demoted
    and rerun in float64 on the card (a makespan that float32 cannot hold
    proves the rerun's result).  Returns the stats it moved."""
    import numpy as np
    from repro_torch.apps import hpcg
    from repro_torch.configs.paper_suite import ANALYSIS
    from repro_torch.core import backend as B
    from repro_torch.core import make_cache
    from repro_torch.core.plan import REPLAY_BYTES_PER_CELL, ExecPolicy
    from repro_torch.core.scheduler import latency_sweep
    from repro_torch.kernels.level_step import level_step
    g, _ = hpcg.trace_cg(n=spec["n"], iters=spec["iters"], cache=make_cache(
        spec["cache"], ANALYSIS.cache_line, ANALYSIS.cache_ways))
    if g.n_vertices != spec["n_vertices"]:
        raise SystemExit(f"dirty sweep: {g.n_vertices} vertices, the JAX "
                         f"package traced {spec['n_vertices']}")
    alphas = spec["alphas"]
    pol = ExecPolicy.resolve(
        mem_budget=2 * REPLAY_BYTES_PER_CELL * g.n_vertices)
    if pol.points_chunk(g.n_vertices, len(alphas)) >= len(alphas):
        raise SystemExit("dirty sweep: the budget does not split the sweep")
    want = np.asarray(spec["makespans"], dtype=np.float64)
    if (want.astype(np.float32).astype(np.float64) == want).all():
        raise SystemExit("dirty sweep: every recorded makespan is exact in "
                         "float32, so no float64 rerun would be checked")
    before, launches = B.stats.snapshot(), level_step.launches
    t0 = time.perf_counter()
    mk = latency_sweep(g, alphas, m=spec["m"],
                       compute_slots=spec["compute_slots"], policy=pol)
    seconds = time.perf_counter() - t0
    moved = {k: v - before.get(k, 0) for k, v in B.stats.snapshot().items()}
    moved["launches"] = level_step.launches - launches
    if not np.array_equal(mk.view(np.int64), want.view(np.int64)):
        raise SystemExit(f"dirty sweep makespans {mk.tolist()} != the JAX "
                         f"package's {want.tolist()}")
    if (moved["chunks"] < 2 or moved["demoted_columns"] <= 0 or
            moved["cuda_chunks"] != moved["chunks"] or
            moved["launches"] <= 0):
        raise SystemExit(f"dirty sweep did not split, demote and rerun on "
                         f"the card: {moved}")
    print(f"  dirty sweep: hpcg cache={spec['cache']} m={spec['m']} "
          f"cs={spec['compute_slots']} alphas={alphas} "
          f"n={g.n_vertices}: makespans equal in {seconds:.1f} s; stats "
          f"moved {moved}", flush=True)
    return moved


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc" / "level_step.cu").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    os.environ["EDAN_TORCH_BACKEND"] = "cuda"
    for knob in ("EDAN_X64", "EDAN_REPLAY_DTYPE", "EDAN_REPLAY_MEM_BUDGET"):
        os.environ.pop(knob, None)
    import numpy as np  # noqa: F401
    from repro_torch.apps import polybench
    from repro_torch.core import backend as B
    from repro_torch.core.plan import ExecPolicy
    from repro_torch.kernels.level_step import level_step
    from repro_torch.launch import paper
    t_start = time.perf_counter()

    with phase("card"):
        card = card_line()
        print(card, flush=True)
        print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
              f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
              flush=True)

    with phase("build"):
        level_step.build()
        print(level_step.build_log.strip() or "  (library already built)",
              flush=True)

    with phase("kernel"):
        gemm = polybench.trace_kernel("gemm", 20)
        gplan = replay_plan(gemm, 4, 8)
        n_alpha = len(paper.ANALYSIS.alpha_sweep)
        cases = [(random_dag(s)._level_csr(), 5, s, f"random DAG {s}")
                 for s in range(3)]
        cases += [(replay_plan(random_dag(s), 2, 3).lv, 5, s,
                   f"random DAG {s} replay m=2 cs=3") for s in range(3)]
        cases += [(gemm._level_csr(), n_alpha, 11, "gemm N=20"),
                  (gplan.lv, n_alpha, 11, "gemm N=20 replay m=4 cs=8")]
        n_cases, max_err = 0, 0.0
        for case in cases:
            n, err = check_kernel(*case)
            n_cases += n
            max_err = max(max_err, err)
        print(f"  {n_cases} kernel/plain cases bitwise equal", flush=True)
        meas = dict(
            gemm_replay_f32=measure(gplan.lv, n_alpha, torch.float32, False,
                                    True, reps=20, plain_reps=2),
            gemm_replay_f64=measure(gplan.lv, n_alpha, torch.float64, False,
                                    True, reps=20, plain_reps=2))
        for key, m in meas.items():
            print(f"  {key}: {json.dumps(m)}", flush=True)
        prof = profile_sweep()
        print(f"  profile: {json.dumps(prof)}", flush=True)

    expected = json.loads((SRC / "repro_torch" / "configs" /
                           "paper_expected.json").read_text())
    with phase("main"):
        level_step.reset_counts()
        B.reset_stats()
        launches = run_main_path(expected, ExecPolicy.resolve(),
                                 paper.FIGURES, "float32")
        if B.stats["cuda_chunks"] <= 0 or B.stats["cpu_chunks"] != 0:
            raise SystemExit(f"replay chunks did not run on the card: "
                             f"{dict(B.stats)}")
        f32_stats = B.stats.snapshot()
        B.reset_stats()
        dirty_stats = run_dirty_sweep(expected["dirty_sweep"])
        B.reset_stats()
        launches_x64 = run_main_path(
            expected, ExecPolicy.resolve(replay_dtype="float64"),
            ("fig10_11", "fig12"), "float64")
        if B.stats["cuda_f64_chunks"] <= 0:
            raise SystemExit(f"no float64 chunk ran on the card: "
                             f"{dict(B.stats)}")
        main_launches = level_step.launches
        main_calls = level_step.calls

    with phase("report"):
        m = meas["gemm_replay_f32"]
        kern = dict(
            name="level_step", route="cuda",
            source="src/repro_torch/csrc/level_step.cu",
            replaces="src/repro/core/backend.py:421",
            launches=main_launches, calls=main_calls, max_abs_err=max_err,
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=m["library_ms"],
            ms_per_launch=m["ms_per_launch"],
            shape=("gemm N=20 replay plan m=4 cs=8, k=11 float32, R_out, "
                   "one call"),
            launches_per_figure=dict(float32=launches, float64=launches_x64),
            stats=dict(float32=f32_stats, dirty_sweep=dirty_stats,
                       float64=B.stats.snapshot()),
            measurements=meas, sweep_profile=prof, kernel_cases=n_cases)
        print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    # the last three lines: the card, the kernels, the verdict
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [kern]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
