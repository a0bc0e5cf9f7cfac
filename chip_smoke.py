#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Phases, each timed; any failure ends the run with a non-zero exit:

1. card    — the card's name and power limit (``nvidia-smi``).
2. build   — compile the four CUDA sources (``csrc/level_step.cu``,
             ``csrc/wkv6.cu``, ``csrc/ssd.cu``, ``csrc/flash_attention.cu``)
             with nvcc, one process each, all started together, and print
             ptxas's register and shared-memory report.
3. kernel  — the CUDA level kernels against their plain PyTorch version on
             the card, float32 and float64, with and without slot chains,
             ready times and the clamp, on seeded random DAGs, on a layered
             DAG whose plan mixes wide and narrow levels (k=11, two column
             tiles), on PolyBench gemm's DAG (N=20, k=1 and 11) and on its
             real replay plan (m=4, 8 ALU slots), on the union replay plan
             of gemm, atax and lu at N=20 over (m, ALU slots) = (2, 0) and
             (4, 8) (``seg_ptr`` blocks), on gemm's class-mode replay plan
             with its object classes and on the class-mode union plan.  F
             and R must be bitwise equal, with one grid per plan row.  Then
             timings: the
             kernels (µs per dependent level, grids per call), the plain
             version and a per-level ``scatter_reduce`` yardstick on the
             main path's shapes, the union plans against their blocks
             replayed member by member (grids, µs per level) and against
             the plain version and the yardstick on the same inputs, and
             HPCG's
             uncached DAG pass (1.79M
             vertices, 49,304 levels, k=1).  Then the WKV6 and SSD kernels against
             their plain versions (chunked at 256, blocked as the kernels
             block, and sequential) at full-width heads, T = 1, 37, 128,
             200, 256 and 2048, a nonzero initial state, the decay-e^-1
             input on which the TPU kernels overflow, and grouped SSD
             cases: finite, within ``REC_TOL``; and their times (CUDA
             events and the kernels' own device time) at the serve shapes
             and at a 2048-token prompt.  Then the flash-attention kernel against
             its plain version in float32 and bf16 (``ATT_CASES``: the
             served models' prefill shapes, zamba2's shared attention,
             heads of 96, 8 and 40, a window, non-causal T=128 over S=384,
             seamless-m4t's non-causal encoder, a ragged T=200): finite,
             within ``ATT_TOL``, and in bf16
             within ``ATT_ROUND_P_TOL`` of the plain version that rounds P
             as the kernel does; and its times at the served shapes
             (seamless-m4t's encoder, decoder and cross-attention over 384
             frames among them; CUDA events, wrapper included, and the
             kernel's own device time from ``torch.profiler``) beside
             the plain version's and one ``scaled_dot_product_attention``
             call's.
4. main    — the paper runner (``repro_torch.launch.paper``) at the paper's
             sizes: PolyBench PAPER_15 at N=20 and HPCG 16^3 x 6 iterations
             (1.79M vertices) under the default replay policy (one
             float64 pass per chunk on the card), then one latency sweep
             of the 32 kB HPCG trace with dirty alphas under the float32
             policy named and a replay budget that splits it into chunks
             (float32 columns demoted and rerun in float64 on the card),
             and the policy-dependent figures (10/11 and 12) again under
             the float64 policy.  Every printed line and every full-precision
             value must equal ``src/repro_torch/configs/paper_expected.json``
             (the JAX package's results), and the kernel's launch counter
             must grow in every figure.
5. suite   — the suite and placement path at ``benchmarks/perf_core.py``'s
             and ``perf_placement.py``'s sizes, against
             ``src/repro_torch/configs/suite_expected.json`` (the JAX
             package's results), every float exact: (a) ``suite_sweep_grid``
             over PAPER_15 at N=20 (15 traces, 554,380 vertices), 13 alphas
             × m in (2, 4, 8) × (0, 8) ALU slots, default policy and
             budget, cold, memo-warm, against the per-member ``sweep_grid``
             loop, and under a budget that splits it into replay groups and
             column chunks (replay chunks all on the card); (b)
             ``suite_t_inf_sweep`` and ``suite_grid_report`` with the
             simulated grid; (c) the class-vector grid with each member's
             object classes (6 rows as wide as the largest object count)
             over the suite of ``CLASS_MEMBERS``, seven PAPER_15 members;
             (d) ``search_placement``, oracle (traces of at most 8 objects;
             gemver has 9) and greedy, on ``PLACEMENT_TRACES``: nine
             PAPER_15 traces and HPCG's CG solve at n=8, with ``oracle <=
             greedy <= all_remote``.  Prints
             seconds, K1's grids, levels and calls, and µs per level for
             the union and the member loop.
6. fixture — the serving path at six small fixture configs (float32) with
             seeded numpy weights (rwkv6, zamba2, qwen3, granite-moe with
             token drops, internvl2 with its 256 patch positions,
             seamless-m4t over zero frames): greedy
             tokens equal and prefill logits close to
             ``src/repro_torch/configs/serve_expected.json`` (the JAX
             package's results).
7. serve   — the serving launcher (``repro_torch.launch.serve.run``) at
             full width: rwkv6-7b, zamba2-7b, qwen3-0.6b,
             granite-moe-1b-a400m, internvl2-2b and seamless-m4t-large-v2
             (bf16 compute, float32 master weights from a seed), 4 slots,
             8 requests of 128 text tokens (internvl2: after 256 patch
             positions; seamless: over 128 zero frames), 16 tokens each.
             Every logit finite, each kernel launched exactly as often as
             the model's layers say (K4 once per attention layer per
             prefill, seamless 72 times: 24 encoder, 24 decoder and 24
             cross layers; never in decode), one prefill and one decode
             step through the kernels held block by block to the plain
             versions' (the recurrent states to the sequential form), and
             for seamless one prefill of 128 tokens over 384 seeded frames
             (the cross-attention with T != S) held the same way; prefill
             ms, decode ms per step, tok/s, peak memory and the profile's
             busy and idle share.
8. persist — the persistent schedule cache and the trace store at
             ``benchmarks/perf_core.py::bench_schedule_cache``'s and
             ``perf_scale.py``'s sizes, against
             ``src/repro_torch/configs/service_expected.json`` (the JAX
             package's results): PolyBench gemm at N=20, 26 alphas in
             [50, 300], ms (2, 4, 8), ALU slots (0, 8), in two cold and two
             warm child processes sharing a cache directory (warm children
             record nothing); HPCG CG at n=13, 7 iterations (1.09M
             vertices) under a 64 MiB replay budget: sweep, save the
             trace, drop it, load it memory-mapped and sweep again from
             the format-4 entry (no recording); and the legacy list build
             of n=8, 3 iterations, equal to the streaming build.  Every
             grid the JAX package's.
9. service — ``benchmarks/perf_service.py``'s full stream (16 waves of 6
             requests over atax, bicg, mvt and gesummv at N=12) through
             the port's ``AnalysisService``: the clean stream (every
             request on rung 0, ``("cuda", None)``: the default, one
             float64 pass, K1 on the card only), the transient stream, the poisoned wave, a ``kernel``
             fault (one rung down, on ``("cuda", "float64")``), a
             ``cache`` fault (quarantined and re-recorded) and one wave
             through the admission thread; every outcome and report the
             JAX package's; requests/s, p50/p99 ms and a profiled wave.
10. frontend — the HLO frontend and the PyTorch-graph frontend against
             ``src/repro_torch/configs/frontend_expected.json`` (the JAX
             package's results): (a) the four HLO fixtures under
             ``configs/hlo/`` (``test_hlo.py``'s SYNTH, its compiled scan
             module, the (2, 4) train and decode steps) through
             ``analyze_collectives``, the FLOP and byte estimates and
             ``collective_sensitivity`` (m=4), every value equal, K1
             launching for the per-axis depths; (b) the apps' PyTorch
             twins in float64 on the card (the eleven PolyBench twins at
             N=20 within 1e-12 of numpy, CG at n=16 x 6 iterations, its
             residual history within 1e-10 of ``reference_solution``,
             LULESH at ne=10 x 3 within 1e-12 of its host run), with
             milliseconds; (c) each twin traced abstractly from float32
             arguments on the card (vertices, edges, levels, seconds to
             trace), its eDAG the recorded one and, for the ten twins
             whose decompositions agree, the JAX package's; ``report``
             and ``sweep_grid`` (13 alphas x m (2, 4, 8) x (0, 8) ALU
             slots) under ``("cuda", "float32")`` bit for bit the JAX
             package's, no replay chunk on the host; (d) K1 bitwise
             against its plain version on the CG twin's DAG and its
             replay plan (m=4, 8 ALU slots).
11. zoo    — model-zoo tracing (``repro_torch.models.tracing``) against
             ``src/repro_torch/configs/zoo_expected.json``: (a) each ``ZOO``
             config at the reduced width, prefill and decode, and the
             train phase of qwen3-0.6b and seamless-m4t-large-v2, traced
             from ``meta`` inputs into a trace store, each eDAG the
             recorded one (vertices, edges, levels, seconds), and
             qwen3-0.6b's decode at full width, 4 of its 28 layers, for
             its seconds; (b)
             ``model_grid_report`` over the six prefill traces (13 alphas x
             m (2, 4, 8) x (0, 8) ALU slots) under ``("cuda", "float32")``,
             every value the JAX package's analysis of the same eDAGs, no
             replay chunk on the host; (c) model requests through the
             ``AnalysisService`` — a clean one and a union batch of three
             on rung 0, a transient and a hard ``trace-model`` fault —
             every outcome and report the fixture's; no model kernel
             launched by tracing; (d) K1 bitwise against its plain version
             on seamless-m4t's prefill replay plan (m=4, 8 ALU slots).
12. train  — the training framework (``repro_torch.train``,
             ``launch.train``): (a) the runs of
             ``src/repro_torch/configs/train_expected.json`` (reduced
             qwen3-0.6b and granite-moe-1b-a400m, float32, 8 steps,
             microbatches 1 and 2, seeded numpy weights) through the port's
             train step with TF32 off, every number within the fixture's
             tolerances of the JAX package's; (b) qwen3-0.6b at full width
             (float32 masters from seed 0, bf16 compute, batch 8 x 128
             tokens) trained 8 steps by ``launch.train.run`` under the
             fault-tolerant loop (checkpoints every 5 steps, keep 1, one
             injected failure): losses finite and falling, one restart;
             step ms, tokens/s, 6·N·tokens per second, peak memory, one
             profiled step's idle share and the optimizer's share of it,
             checkpoint save and restore seconds; none of K2-K4 launched
             in (a) or (b); (c) the last checkpoint restored and served by
             ``ServeEngine`` (one 128-token prefill, 3 decode steps: K4 28
             times, once per layer, none in decode), one prefill and
             decode step held block by block to the plain path within
             ``SERVE_TOL``; (d) EDAN on the train step itself (the reduced
             model's loss, gradient and AdamW update traced from ``meta``
             inputs): ``report`` and a sweep grid under ``("cuda",
             "float32")``, W >= D >= 1 and 0 <= Lambda <= 1, K1 launched,
             no replay chunk on the host.
13. dryrun — the dry-run (``repro_torch.launch.dryrun``): (a) each cell
             of ``src/repro_torch/configs/dryrun_expected.json`` (the JAX
             package's ``run_cell`` on 256 or 512 fake devices) through the
             port's ``run_cell`` without its per-device step: ``skipped``,
             the collectives, per-axis lambda, HLO FLOPs and bytes (the
             reference's compiled text through ``core/hlo.py``, K1 on the
             card for the per-axis depths) and the model FLOPs equal, XLA's
             argument, alias and output bytes exact, the temp bytes
             replayed from the text (``core.hlo.hlo_temp_bytes``) within
             ``DRYRUN_TEMP_RATIO`` of XLA's and ``fits_hbm`` equal,
             seconds per cell;
             (b) qwen3-0.6b on the card's 1x1 mesh (float32 masters,
             bf16 compute) at phase "train"'s shape, batch 8 x 128, where
             the end of AdamW sets the peak, and at 8 x 1024, where the
             activations do, each with ``remat="block"`` and ``"none"``:
             the dry-run's estimated peak (argument + temp, from the step
             run on ``meta`` tensors) against
             ``torch.cuda.max_memory_allocated()`` over one real step
             after a warm-up step, within ``DRYRUN_PEAK_RATIO`` in all
             four, and at 8 x 1024 "block"'s estimate below "none"'s;
             ``FlopCounterMode``'s FLOPs beside 6·N·tokens; the measured
             step ms beside the roofline's compute and memory seconds on
             the H100's rates.
14. moe    — the MoE layer's multi-rank paths (``models/moe.py`` under a
             ``RankMesh``, ``repro_torch.launch.moe_parallel``), ranks as
             processes that share the card over ``gloo`` with their tensors
             on it: (a) the CPU tests' case, reduced granite (d 64, 8
             experts, top-2, capacity factor 8) on a (2, 4) mesh of 8 ranks:
             "tp", "ep" and "tp" + ``moe_scatter_out`` within
             ``MOE_TOL`` of the single-rank output and gradients of the
             input and every weight, a mesh without groups bit for bit the
             single-rank path; (b) granite-moe-1b-a400m at full width
             (float32 masters from seed 0, bf16 compute) on a (1, 4) mesh
             of 4 ranks, one prefill of 4 x 128 tokens in "tp", the
             scatter and "ep" at capacity factor 4 (no pair can drop): each
             block within ``SERVE_TOL`` of the single-rank block on the
             same input (rank 0's, broadcast), the MoE outputs' and the
             logits' differences reported; the dropped
             pairs of one rank and of "ep" at the config's 1.25; per rank
             ms per MoE layer, collectives and bytes per layer, K4
             launches and peak memory.  The ranks contend for one card:
             their times say nothing of four cards.
15. shard  — the sharded train step (``train_loop.jit_train_step`` on a
             ``RankMesh``, ``repro_torch.launch.sharded``), ranks as
             processes that share the card over ``gloo``, every family on
             its tensor-parallel path: (a) the CPU tests' 8-rank case on
             (2, 4) with TF32 off, all eight cases of
             ``src/repro_torch/configs/shard_expected.json`` (the JAX
             package's ``jit_train_step`` on 8 host devices: qwen3,
             granite-moe, rwkv6, internvl2 with its patch prefix, zamba2,
             seamless with its frames) within ``tools/shard_expected.py``'s
             tolerances; (b) rwkv6-7b at full width (d 4096, 64 heads,
             d_ff 14336, vocabulary 65,536), 4 of its 32 layers (1.41B
             parameters: its masters and moments at full depth exceed the
             card), 2 steps, then qwen3-0.6b at full width, 4 of its 28
             layers, 1 step (float32 masters from seed 0, bf16 compute),
             each on a (2, 2) mesh of 4 ranks, the launcher's ``run`` on
             8 x 128 tokens a step under ``ShardedLoop``: losses finite,
             the tensor-parallel path, step 1's loss within
             ``SHARD_LOSS_TOL`` and its gradient norm within
             ``SHARD_GNORM_TOL`` of one rank's step on the same batch
             (rwkv6's within ``SHARD_GNORM_BF16_TOL``: its bonus ``u``'s,
             which bf16 rounding moves), and the same step's gradient in
             float32 on the ranks (``launch.sharded.first_grads``): its
             loss within ``SHARD_LOSS_TOL``, the norm of every leaf and of
             all of them within ``SHARD_GNORM_TOL`` of one rank's; every
             rank's peak memory below half of that step's; ms per
             step, collectives and bytes per step and rank; (c) each last
             checkpoint (the full tree rank 0 assembled) restored by one
             process, each rank's blocks of it its shards, and served: one
             128-token prefill (rwkv6 through K2 once per layer, qwen3
             through K4 once per layer), every block (and K4 call) within
             ``SERVE_TOL`` of the plain path, rwkv6's states within
             ``REC_TOL`` of the sequential form.  The ranks contend for
             one card: their times say nothing of four cards.
16. report — the card line, the ``{"kernels": [...]}`` line, and last the
             ``{"ok": true, "device": {...}}`` line.

Usage: python3 chip_smoke.py   (from the root of a checkout, one card)
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
#: the H100 SXM's device memory rate and float32 (outside the tensor
#: cores) and dense bf16 rates: ``configs.base.HW``'s, set in ``main``
HBM_BYTES_PER_S = F32_OPS_PER_S = BF16_OPS_PER_S = None


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


def layered_dag(widths, seed: int = 0):
    """Layers of the given widths, each vertex fed by one to three of the
    layer before: a DAG whose levels alternate between wide and narrow."""
    import numpy as np
    from repro_torch.core.graph import EDag
    rng = np.random.default_rng(seed)
    src, dst, prev, n = [], [], [], 0
    for w in widths:
        cur = list(range(n, n + w))
        for v in cur:
            if prev:
                for u in rng.choice(prev, size=min(len(prev), int(
                        rng.integers(1, 4))), replace=False):
                    src.append(int(u))
                    dst.append(v)
        prev, n = cur, n + w
    is_mem = rng.random(n) < 0.5
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


def check_kernel(lv, k: int, seed: int, label: str, wide: bool = False):
    """Kernels vs plain version, bitwise, over dtype x R_out x clamp, on
    dirty bases, with one grid per row of the plan; ``wide``: the plan must
    hold wide-level rows.  Returns (cases, largest |kernel - plain|
    seen)."""
    import torch
    from repro_torch.kernels.level_step import (level_step, level_step_plain,
                                                narrow_width)
    slot = lv.qpred is not None
    plan = lv.level_plan(narrow_width(k))
    if wide and not (plan[:, 2] != 0).any():
        raise SystemExit(f"{label}: no wide level at k={k}")
    n_cases, err = 0, 0.0
    for dtype in (torch.float32, torch.float64):
        for clamp in (False, True):
            base = base_matrix(lv, k, seed, dtype, slot, dirty=True)
            # the plain version once, with its ready times: F does not
            # depend on whether they are kept.  It runs on the host: its
            # operations are exact (comparisons, copies and one IEEE add
            # per element), so its bits do not depend on the device, and
            # on the large plans a call takes a third of its time on the
            # card (on one thread: its operations are small)
            Fp, Rp = base.cpu(), torch.zeros_like(base, device="cpu")
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                level_step_plain(lv, Fp, clamp=clamp, R_out=Rp)
            finally:
                torch.set_num_threads(threads)
            Fp, Rp = Fp.to(base.device), Rp.to(base.device)
            for want_r in (False, True):
                Fk = base.clone()
                Rk = torch.zeros_like(base) if want_r else None
                n0 = level_step.launches
                level_step(lv, Fk, clamp=clamp, R_out=Rk)
                if level_step.launches - n0 != len(plan):
                    raise SystemExit(f"{label}: {level_step.launches - n0} "
                                     f"grids for a plan of {len(plan)} rows")
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
          f"k={k}: {n_cases} cases bitwise equal; plan {len(plan)} grids "
          f"({int(plan[:, 2].sum())} wide levels, "
          f"{int((plan[:, 2] == 0).sum())} narrow segments)", flush=True)
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
    levels0 = level_step.levels
    ms = time_ms(lambda F: level_step(lv, F, clamp=clamp, R_out=R()), bases)
    calls = max(level_step.calls - calls0, 1)
    per_call = (level_step.launches - launches0) / calls
    levels = (level_step.levels - levels0) / calls
    plain = lib = None
    if plain_reps:
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
                launches_per_call=per_call, levels_per_call=levels,
                us_per_level=1e3 * ms / max(levels, 1),
                plain_ms=plain, library_ms=lib,
                bound_ms=bound, bound_by=bound_by,
                n=lv.n, levels=lv.n_levels, edges=int(len(lv.esrc)), k=k,
                dtype=str(dtype).replace("torch.", ""))


def hpcg_dag_pass(reps: int = 3) -> dict:
    """HPCG's uncached DAG pass at paper size (n=16, 6 iterations: 1.79M
    vertices, 49,304 levels), one column, through the kernels: ms per call
    (CUDA events over ``reps`` calls after one warm-up), grids and levels
    per call, µs per level.  (Its result is checked in phase "main", where
    table 1 runs the same pass.)"""
    import torch
    from repro_torch.apps import hpcg
    from repro_torch.kernels.level_step import level_step, narrow_width
    g, _ = hpcg.trace_cg(n=16, iters=6)
    lv = g._level_csr()
    plan = lv.level_plan(narrow_width(1))
    bases = [torch.ones((lv.n, 1), device="cuda") for _ in range(reps)]
    launches0, levels0 = level_step.launches, level_step.levels
    calls0 = level_step.calls
    ms = time_ms(lambda F: level_step(lv, F, clamp=False), bases, warmup=1)
    calls = level_step.calls - calls0
    levels = (level_step.levels - levels0) / calls
    return dict(n=lv.n, levels=lv.n_levels, k=1, dtype="float32", ms=ms,
                launches_per_call=(level_step.launches - launches0) / calls,
                levels_per_call=levels, us_per_level=1e3 * ms / levels,
                wide_levels=int(plan[:, 2].sum()),
                narrow_segments=int((plan[:, 2] == 0).sum()))


def profile_call(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall seconds, the
    device's busy seconds (kernel times summed), the level kernels' share
    of them and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = level = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        busy += dev_us
        if "level_kernel" in ev.key or "segment_kernel" in ev.key:
            level += dev_us
    if busy <= 0:
        return dict(wall_s=wall, device_busy_s="not measured")
    return dict(wall_s=wall, device_busy_s=busy / 1e6,
                level_kernel_s=level / 1e6,
                device_idle_share=max(0.0, 1.0 - busy / 1e6 / wall))


def profile_sweep(name: str = "gemm", N: int = 20) -> dict:
    """One fig 10/11 sweep (``sweep_report`` with the simulated points) of
    one PolyBench kernel under ``torch.profiler`` (``profile_call``)."""
    from repro_torch.apps import polybench
    from repro_torch.core import sweep_report
    from repro_torch.launch import paper
    g = polybench.trace_kernel(name, N)
    g._finalize()
    return dict(kernel=f"{name} N={N}", **profile_call(lambda: sweep_report(
        g, paper.ANALYSIS.alpha_sweep, simulate_points=True,
        compute_slots=paper.SIM_COMPUTE_SLOTS, use_cache=False)))


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
    cache) on the card under the float32 policy named, with a replay
    budget of two columns per chunk: the makespans must equal the recorded
    ones bit for bit, the budget must split the sweep, and columns must be
    demoted by the certificate or its pre-screen and rerun in float64 on
    the card (a makespan that float32 cannot hold proves the rerun's
    result).  Returns the stats it moved."""
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
        replay_dtype="float32",
        mem_budget=2 * REPLAY_BYTES_PER_CELL * g.n_vertices)
    if pol.points_chunk(g.n_vertices, len(alphas)) >= len(alphas):
        raise SystemExit("dirty sweep: the budget does not split the sweep")
    want = np.asarray(spec["makespans"], dtype=np.float64)
    if (want.astype(np.float32).astype(np.float64) == want).all():
        raise SystemExit("dirty sweep: every recorded makespan is exact in "
                         "float32, so no float64 rerun would be checked")
    before, launches = B.stats.snapshot(), level_step.launches
    levels = level_step.levels
    t0 = time.perf_counter()
    mk = latency_sweep(g, alphas, m=spec["m"],
                       compute_slots=spec["compute_slots"], policy=pol)
    seconds = time.perf_counter() - t0
    moved = {k: v - before.get(k, 0) for k, v in B.stats.snapshot().items()}
    moved["launches"] = level_step.launches - launches
    moved["levels"] = level_step.levels - levels
    if not np.array_equal(mk.view(np.int64), want.view(np.int64)):
        raise SystemExit(f"dirty sweep makespans {mk.tolist()} != the JAX "
                         f"package's {want.tolist()}")
    if (moved["chunks"] < 2 or moved["demoted_columns"] <= 0 or
            moved["latency_bound_chunks"] != 0 or
            moved["cuda_chunks"] != moved["chunks"] or
            moved["launches"] <= 0):
        raise SystemExit(f"dirty sweep did not split, demote and rerun on "
                         f"the card: {moved}")
    print(f"  dirty sweep: hpcg cache={spec['cache']} m={spec['m']} "
          f"cs={spec['compute_slots']} alphas={alphas} "
          f"n={g.n_vertices}: makespans equal in {seconds:.1f} s; stats "
          f"moved {moved}", flush=True)
    return moved


# ------------------------------------------------- recurrence kernel phase

#: kernel against plain version: max |kernel - plain| over max |plain|, for
#: y and for the final state.  Both compute the same float32 recurrence; the
#: plain chunked form takes exp of cumulative log-decay differences and sums
#: in another order (measured <= 1e-6 on the card in the first probe).
REC_TOL = 1e-5
#: full-width serving, kernels' path against plain versions' path, block by
#: block on the same inputs: max |Δ| of a block's output hidden state (bf16)
#: over its largest magnitude.  The recurrence outputs differ by ~1e-6
#: (REC_TOL); that can flip bf16 roundings (8 significant bits) downstream
#: in the block, which moves an element by 2^-8 of itself, a few such in
#: a row by a few times that.
SERVE_TOL = 2.0 ** -6
#: the serve shapes of each recurrence: (label, batch, T); the prefill runs
#: one request at a time, the decode step all 4 slots
SERVE_SHAPES = (("T=1", 4, 1), ("T=128", 1, 128))
#: the timed shapes: the serve shapes and one long prompt
REC_TIME_SHAPES = SERVE_SHAPES + (("T=2048", 1, 2048),)


def wkv6_inputs(B, H, T, K, V, seed, fault=False):
    """Seeded float32 inputs on the card: decays in (0.45, 0.95), or all
    e^-1 (the fault-1 input), a nonzero random initial state."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=g, device="cuda") * scale
    r, k, v = rn(B, H, T, K), rn(B, H, T, K, scale=0.3), rn(B, H, T, V)
    w = (torch.full((B, H, T, K), float(torch.e ** -1), device="cuda")
         if fault else torch.sigmoid(rn(B, H, T, K)) * 0.5 + 0.45)
    return r, k, v, w, rn(H, K, scale=0.1), rn(B, H, K, V, scale=0.1)


def ssd_inputs(B, H, T, P, N, G, seed, fault=False):
    """Seeded float32 inputs on the card: dt ~ 0.2 softplus, or dt=1 with
    A=-1 (decay e^-1, the fault-1 input), a nonzero random initial state."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=g, device="cuda") * scale
    x = rn(B, H, T, P)
    if fault:
        dt = torch.ones((B, H, T), device="cuda")
        A = -torch.ones(H, device="cuda")
    else:
        dt = 0.2 * torch.nn.functional.softplus(rn(B, H, T))
        A = -torch.exp(0.3 * rn(H))
    return (x, dt, A, rn(B, G, T, N, scale=0.4), rn(B, G, T, N, scale=0.4),
            rn(H, scale=0.1), rn(B, H, P, N, scale=0.1))


def rel_err(a, b) -> float:
    return abs_err(a, b) / max(b.double().abs().max().item(), 1e-30)


def check_recurrences() -> dict:
    """K2 and K3 against their plain versions (chunked at the configs'
    256, blocked as the kernels block, and sequential) on the card, at
    full-width heads, T below one block, ragged, and 2048 long: every
    output finite, y and the final state within REC_TOL.  Returns per
    kernel the cases, the largest |Δ| and the largest relative |Δ|."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    cases = [("wkv6", wkv6, ref.wkv6_chunked_ref, ref.wkv6_blocked_ref,
              ref.wkv6_ref,
              wkv6_inputs(B, 64, T, 64, 64, seed=T + int(f), fault=f),
              f"B={B} H=64 T={T} K=V=64{' decay e^-1' if f else ''}")
             for B, T, f in ((4, 1, False), (4, 37, False), (4, 128, False),
                             (4, 200, False), (4, 256, False),
                             (4, 256, True), (1, 2048, False))]
    cases += [("ssd", ssd, ref.ssd_chunked_ref, ref.ssd_blocked_ref,
               ref.ssd_ref,
               ssd_inputs(B, 112, T, 64, 64, G, seed=T + G + int(f), fault=f),
               f"B={B} H=112 T={T} P=N=64 G={G}"
               f"{' decay e^-1' if f else ''}")
              for B, T, G, f in ((2, 1, 1, False), (2, 37, 1, False),
                                 (2, 128, 1, False), (2, 200, 1, False),
                                 (2, 256, 1, False), (2, 256, 1, True),
                                 (2, 128, 2, False), (2, 200, 2, False),
                                 (1, 2048, 1, False))]
    out = {}
    for name, kernel, chunked, blocked, seq, args, label in cases:
        n0 = kernel.launches
        y, S = kernel(*args, chunk=256)
        torch.cuda.synchronize()
        if kernel.launches != n0 + 1:
            raise SystemExit(f"{name} {label}: {kernel.launches - n0} "
                             f"launches in one call")
        if not (torch.isfinite(y).all() and torch.isfinite(S).all()):
            raise SystemExit(f"{name} {label}: non-finite output")
        errs = {}
        for form, fn in (("chunked", lambda *a: chunked(*a, chunk=256)),
                         ("blocked", blocked), ("sequential", seq)):
            yp, Sp = fn(*args)
            errs[form] = (rel_err(y, yp), rel_err(S, Sp),
                          max(abs_err(y, yp), abs_err(S, Sp)))
            if max(errs[form][:2]) > REC_TOL:
                raise SystemExit(f"{name} {label}: kernel vs {form} plain "
                                 f"version: relative |Δ| y "
                                 f"{errs[form][0]:.3e} state "
                                 f"{errs[form][1]:.3e} > {REC_TOL}")
        print(f"  {name} {label}: relative |Δ| (y, state) vs " +
              ", ".join(f"{form} {e[0]:.2e} {e[1]:.2e}"
                        for form, e in errs.items()), flush=True)
        rec = out.setdefault(name, dict(cases=0, max_abs_err=0.0,
                                        max_rel_err=0.0))
        rec["cases"] += 1
        rec["max_abs_err"] = max(rec["max_abs_err"], errs["chunked"][2])
        rec["max_rel_err"] = max(rec["max_rel_err"],
                                 *(r for e in errs.values() for r in e[:2]))
    return out


def recurrence_bound(name: str, args) -> tuple:
    """Least milliseconds for one call and what sets it: every input read
    once and y and the final state written once over the memory rate,
    against the float32 operations over the float32 rate (WKV6: 7 per
    (t, k, v); SSD: 5 per (t, p, n))."""
    if name == "wkv6":
        r, k, v, w, u, s0 = args
        B, H, T, K = r.shape
        V = v.shape[-1]
        elems = 3 * r.numel() + v.numel() + u.numel() + 2 * s0.numel() + \
            B * H * T * V
        ops = 7 * B * H * T * K * V
    else:
        x, dt, A, Bm, Cm, D, s0 = args
        B, H, T, P = x.shape
        N = Bm.shape[-1]
        elems = 2 * x.numel() + dt.numel() + 2 * A.numel() + \
            2 * Bm.numel() + 2 * s0.numel()
        ops = 5 * B * H * T * P * N
    t_bytes = 4 * elems / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_calls(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back calls after
    one warm-up, CUDA events."""
    import torch
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


def time_recurrences() -> dict:
    """K2 and K3 at the serve shapes and at one 2048-token prompt: the
    kernel's ms per launch (CUDA events over 100 launches, wrapper
    included) and its own device µs per launch (``device_us``), the plain
    chunked version's ms (chunk 256, 5 calls) and the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    out = {}
    for label, B, T in REC_TIME_SHAPES:
        for name, kernel, plain, args in (
                ("wkv6", wkv6, ref.wkv6_chunked_ref,
                 wkv6_inputs(B, 64, T, 64, 64, seed=9)),
                ("ssd", ssd, ref.ssd_chunked_ref,
                 ssd_inputs(B, 112, T, 64, 64, 1, seed=9))):
            bound, by = recurrence_bound(name, args)
            out.setdefault(name, {})[label] = dict(
                batch=B, T=T,
                ms=time_calls(lambda: kernel(*args, chunk=256), 100),
                device_us=device_us(lambda: kernel(*args, chunk=256)),
                plain_ms=time_calls(lambda: plain(*args, chunk=256), 5),
                bound_ms=bound, bound_by=by)
    for name, rows in out.items():
        print(f"  {name} timings: {json.dumps(rows)}", flush=True)
    return out


# ------------------------------------------------- flash attention phase

#: K4 against its plain version on the card: max |Δ| over max |plain|.
#: Both run the float32 online softmax over the kernels' KV tiles (64 keys
#: in float32, 128 in bf16), summed in other orders (float32: ~1e-7); in bf16 the output's rounding to bf16
#: (at most 2^-8 of a value) can flip, and the bf16 kernel rounds P to
#: bf16 (2^-9 of each probability) where this plain version does not.
ATT_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
#: bf16 K4 against the plain version that rounds P to bf16 as the kernel
#: does (``round_p=True``), element by element: |Δ| at most ATT_ROUND_P_TOL
#: [0] of the plain value (one bf16 ulp: the float32 sums, in another
#: order, can flip the output's rounding) plus [1] of the largest |plain|
#: (they can flip a probability's rounding, which moves an output by 2^-8
#: p/l |v|).
ATT_ROUND_P_TOL = (2.0 ** -7, 2.0 ** -10)
#: (label, B, T, S, H, KV, hd, causal, window)
ATT_CASES = (
    ("qwen3-0.6b", 1, 128, 128, 16, 8, 128, True, 0),
    ("granite-moe-1b-a400m", 1, 128, 128, 16, 8, 64, True, 0),
    ("internvl2-2b", 1, 384, 384, 16, 8, 128, True, 0),
    ("zamba2-7b shared attention", 1, 128, 128, 32, 32, 112, True, 0),
    ("hd=96 (phi3)", 2, 128, 128, 32, 32, 96, True, 0),
    ("window 64", 2, 256, 256, 16, 8, 128, True, 64),
    ("non-causal T=128 S=384", 2, 128, 384, 16, 16, 64, False, 0),
    ("seamless-m4t-large-v2 encoder", 1, 128, 128, 16, 16, 64, False, 0),
    ("ragged T=200", 2, 200, 200, 16, 8, 128, True, 0),
    ("hd=8", 2, 128, 128, 16, 8, 8, True, 0),
    ("hd=40 window 48", 2, 200, 200, 16, 8, 40, True, 48),
)
#: the prefill shapes of the served models, one request: (label, T, S, H,
#: KV, hd, causal), bf16; seamless-m4t-large-v2's encoder (frames as many
#: as the prompt's tokens, as the engine gives them), decoder, and
#: cross-attention over 384 frames (T != S, as ``prefill_fn`` takes it)
ATT_SERVE_SHAPES = (("qwen3-0.6b", 128, 128, 16, 8, 128, True),
                    ("granite-moe-1b-a400m", 128, 128, 16, 8, 64, True),
                    ("internvl2-2b", 384, 384, 16, 8, 128, True),
                    ("zamba2-7b", 128, 128, 32, 32, 112, True),
                    ("seamless encoder", 128, 128, 16, 16, 64, False),
                    ("seamless decoder", 128, 128, 16, 16, 64, True),
                    ("seamless cross Te=384", 128, 384, 16, 16, 64, False))
#: keys per KV tile of K4's kernels (``csrc/flash_attention.cu``), by dtype
ATT_BLOCK_KV = {"float32": 64, "bfloat16": 128}


def att_inputs(B, T, S, H, KV, hd, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, T, H, hd, generator=g, device="cuda")
    k = torch.randn(B, S, KV, hd, generator=g, device="cuda")
    v = torch.randn(B, S, KV, hd, generator=g, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def round_p_excess(o, p) -> float:
    """Largest |o - p| beyond ATT_ROUND_P_TOL[0] of |p|, over max |p|."""
    pd = p.double()
    ex = (o.double() - pd).abs() - ATT_ROUND_P_TOL[0] * pd.abs()
    return max(ex.max().item(), 0.0) / max(pd.abs().max().item(), 1e-30)


def check_attention() -> dict:
    """K4 against ``flash_attention_plain`` (KV blocks of
    ``ATT_BLOCK_KV``, as the kernels' tiles) on the card at every case of
    ``ATT_CASES``, in float32 and bf16: finite, within ``ATT_TOL``; in bf16
    also within ``ATT_ROUND_P_TOL`` of the plain version with
    ``round_p=True``.  Returns the cases, the largest |Δ| and relative |Δ|
    against the plain version, the largest relative |Δ| against the
    rounding one and the largest excess over one ulp there."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_plain
    out = dict(cases=0, max_abs_err=0.0, max_rel_err=0.0,
               max_rel_err_round_p=0.0, max_round_p_excess=0.0)
    for i, (label, B, T, S, H, KV, hd, causal, window) in \
            enumerate(ATT_CASES):
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = att_inputs(B, T, S, H, KV, hd, dtype, seed=i)
            o = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            name = str(dtype).replace("torch.", "")
            if not torch.isfinite(o).all() or o.dtype != dtype:
                raise SystemExit(f"flash_attention {label} {name}: "
                                 f"non-finite output or dtype {o.dtype}")
            p = flash_attention_plain(q, k, v, causal=causal, window=window,
                                      block_kv=ATT_BLOCK_KV[name])
            rel = rel_err(o, p)
            errs.append(f"{name} {rel:.2e}")
            if rel > ATT_TOL[name]:
                raise SystemExit(f"flash_attention {label} {name}: kernel "
                                 f"vs plain version: relative |Δ| "
                                 f"{rel:.3e} > {ATT_TOL[name]:.3e}")
            if dtype == torch.bfloat16:
                pr = flash_attention_plain(q, k, v, causal=causal,
                                           window=window,
                                           block_kv=ATT_BLOCK_KV[name],
                                           round_p=True)
                rel_r, excess = rel_err(o, pr), round_p_excess(o, pr)
                errs.append(f"vs round_p {rel_r:.2e} (beyond one ulp "
                            f"{excess:.2e})")
                if excess > ATT_ROUND_P_TOL[1]:
                    raise SystemExit(
                        f"flash_attention {label}: kernel vs round_p plain "
                        f"version: |Δ| beyond one ulp {excess:.3e} > "
                        f"{ATT_ROUND_P_TOL[1]:.3e} of the largest")
                out["max_rel_err_round_p"] = max(out["max_rel_err_round_p"],
                                                 rel_r)
                out["max_round_p_excess"] = max(out["max_round_p_excess"],
                                                excess)
            out["cases"] += 1
            out["max_abs_err"] = max(out["max_abs_err"], abs_err(o, p))
            out["max_rel_err"] = max(out["max_rel_err"], rel)
        print(f"  flash_attention {label} (B={B} T={T} S={S} H={H} KV={KV} "
              f"hd={hd} causal={causal} window={window}): relative |Δ| vs "
              f"plain {', '.join(errs)}", flush=True)
    # views whose strides and base are not 16-byte aligned (element loads
    # in the bf16 kernel) give the contiguous inputs' result
    for dtype in (torch.float32, torch.bfloat16):
        wide = att_inputs(2, 200, 200, 16, 8, 129, dtype, seed=99)
        views = [t[..., 1:] for t in wide]
        if not torch.equal(flash_attention(*views),
                           flash_attention(*(t.contiguous()
                                             for t in views))):
            raise SystemExit(f"flash_attention {dtype}: unaligned views "
                             f"differ from contiguous inputs")
        out["cases"] += 1
    print("  flash_attention: unaligned strided views equal the contiguous "
          "inputs' result (hd=128)", flush=True)
    return out


def attention_bound(B, T, S, H, KV, hd, causal, window, itemsize) -> tuple:
    """Least milliseconds for one call and what sets it: q, k, v read once
    and o written once over the memory rate, against the operations the
    mask lets through (2 for q.k and 2 for p.v per head dimension and
    unmasked (query, key) pair) over the bf16 tensor-core rate."""
    import torch
    qpos, kpos = torch.arange(T)[:, None], torch.arange(S)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    ops = 4 * hd * int(mask.sum()) * B * H
    t_bytes = itemsize * (2 * B * T * H * hd + 2 * B * S * KV * hd) / \
        HBM_BYTES_PER_S
    t_ops = ops / BF16_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_us(fn, reps: int = 20, windows: int = 3):
    """Device microseconds per call of ``fn``: the CUDA kernels' device
    times under ``torch.profiler`` over ``reps`` calls after one warm-up,
    summed and divided by ``reps`` (the host's launch cost is not in it);
    the median of ``windows`` such windows, as a window now and then
    records no kernel at all."""
    import statistics
    import torch
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
        dev = sum(getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0.0))
                  for ev in prof.key_averages()
                  if getattr(ev, "device_type", None) == DeviceType.CUDA)
        if dev > 0:
            per_call.append(dev / reps)
    return statistics.median(per_call) if per_call else "not measured"


def time_attention() -> dict:
    """K4 at the served prefill shapes in bf16: ms per launch (CUDA
    events over 100 launches, wrapper included) and the kernel's own
    device µs per launch (``torch.profiler``); the plain version's ms (5
    calls); the bound; and as ``library_ms`` / ``library_device_us`` one
    ``scaled_dot_product_attention`` call on (B,H,T,hd) copies of the same
    inputs (timed here only; the port never calls it), held to the
    kernel's output within SERVE_TOL.  Last, one (batch, head) alone at
    T=128 and 1024, whose longest CTA runs 1 and 8 KV tiles: the µs per
    tile of one CTA's serial chain."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_plain
    out = {}
    for label, T, S, H, KV, hd, causal in ATT_SERVE_SHAPES:
        q, k, v = att_inputs(1, T, S, H, KV, hd, torch.bfloat16, seed=9)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal, enable_gqa=True)

        def kernel():
            return flash_attention(q, k, v, causal=causal)
        lib_err = rel_err(sdpa().transpose(1, 2), kernel())
        if lib_err > SERVE_TOL:
            raise SystemExit(f"scaled_dot_product_attention disagrees with "
                             f"the kernel at {label}: {lib_err:.3e}")
        bound, by = attention_bound(1, T, S, H, KV, hd, causal, 0, 2)
        out[label] = dict(
            T=T, S=S, H=H, KV=KV, hd=hd, causal=causal, dtype="bfloat16",
            ms=time_calls(kernel, 100), device_us=device_us(kernel),
            plain_ms=time_calls(lambda: flash_attention_plain(
                q, k, v, causal=causal,
                block_kv=ATT_BLOCK_KV["bfloat16"]), 5),
            library_ms=time_calls(sdpa, 100),
            library_device_us=device_us(sdpa), library_rel_err=lib_err,
            bound_ms=bound, bound_by=by)
    # one (batch, head) alone, T = 128 and 1024 keys: the serial chain of
    # one CTA over its KV tiles, which the served shapes wait on
    chain = {}
    for T in (128, 1024):
        q, k, v = att_inputs(1, T, T, 1, 1, 128, torch.bfloat16, seed=9)
        chain[f"T={T}"] = device_us(lambda: flash_attention(q, k, v))
    out["one head, hd=128"] = dict(device_us=chain, us_per_kv_tile=(
        (chain["T=1024"] - chain["T=128"]) / 7
        if "not measured" not in chain.values() else "not measured"))
    print(f"  flash_attention timings: {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------- suite phase

#: the members of the union replay plan K1 is held on in phase "kernel"
UNION_MEMBERS = ("gemm", "atax", "lu")
UNION_PAIRS = [(2, 0), (4, 8)]
#: the wide union: the PAPER_15 members but the five deepest, at the pairs
#: of phase "suite"'s m=8 call.  Its blocks side by side make 121 of its
#: levels (70 of its class-mode plan's) wider than a segment takes at
#: k=13, so its plan mixes wide-level grids with narrow segments, as the
#: PAPER_15 union's does.
WIDE_DROP = ("2mm", "3mm", "doitgen", "gemm", "symm")
WIDE_PAIRS = [(8, 0), (8, 8)]


def class_row(width: int):
    """Class 0 local at alpha 1, the rest remote at 200."""
    import numpy as np
    row = np.full(width, 200.0)
    row[0] = 1.0
    return row


def with_classes(members) -> int:
    """Give each member its ``object_class_map`` overlay; returns the
    largest object count."""
    from repro_torch.core import object_class_map, objects_from_edag
    width = 0
    for g in members:
        objs = objects_from_edag(g)
        g.set_mem_classes(object_class_map(g, objs))
        width = max(width, len(objs))
    return width


def union_plans(N: int = 20):
    """K1's suite plan shapes: the union replay plan of ``UNION_MEMBERS``
    at N over ``UNION_PAIRS`` (block-diagonal, ``seg_ptr`` set, blocks
    interleaving per level), gemm's class-mode replay plan with its
    ``object_class_map`` classes (slot provenance chains; ``class_row``)
    and the class-mode union plan of the same members; then the wide
    union of the PAPER_15 members but ``WIDE_DROP`` over ``WIDE_PAIRS``
    and its class-mode plan.  Returns (suite, union plan, class-mode plan,
    class-mode union plan, wide suite, wide union plan, wide class-mode
    union plan)."""
    from repro_torch.apps import polybench
    from repro_torch.core import EDagSuite
    from repro_torch.core import scheduler as S
    from repro_torch.core import suite as SU
    members = [polybench.trace_kernel(nm, N) for nm in UNION_MEMBERS]
    suite = EDagSuite(members, names=list(UNION_MEMBERS))
    union = SU._build_suite_plan(suite, UNION_PAIRS, 1.0, 50.0, False)
    width = with_classes(members)
    row = class_row(width)
    g = members[0]
    _, cplan = S._record_plan_classes(
        g, g._sim_lists(), 4, 8, row, g.mem_class_column(width), 1.0,
        None, False)
    cunion = SU._build_suite_plan(suite, UNION_PAIRS, 1.0, row, False,
                                  n_classes=width)
    for g in members:
        g.set_mem_classes(None)
    names = [nm for nm in polybench.PAPER_15 if nm not in WIDE_DROP]
    wide = EDagSuite([polybench.trace_kernel(nm, N) for nm in names],
                     names=names)
    wunion = SU._build_suite_plan(wide, WIDE_PAIRS, 1.0, 50.0, False)
    width = with_classes(wide.members)
    wcunion = SU._build_suite_plan(wide, WIDE_PAIRS, 1.0, class_row(width),
                                   False, n_classes=width)
    for g in wide.members:
        g.set_mem_classes(None)
    return suite, union, cplan, cunion, wide, wunion, wcunion


def union_vs_members(suite, union, pairs, k: int, reps: int = 10) -> dict:
    """K1 on a union replay plan against the same blocks replayed one
    member plan at a time (float32, ready times, ``k`` columns): ms per
    call, grids, levels and µs per dependent level of each, the union's
    bound, and the union's plain version and ``scatter_reduce`` yardstick
    (``library_version``) on the same inputs."""
    import torch
    from repro_torch.kernels.level_step import level_step, level_step_plain

    def timed(lv, seed):
        bases = [base_matrix(lv, k, seed + i, torch.float32, True)
                 for i in range(reps)]
        n0, l0, c0 = (level_step.launches, level_step.levels,
                      level_step.calls)
        ms = time_ms(lambda F: level_step(
            lv, F, clamp=False, R_out=torch.zeros_like(F)), bases)
        calls = level_step.calls - c0
        return (ms, (level_step.launches - n0) / calls,
                (level_step.levels - l0) / calls)

    ms, grids, levels = timed(union.lv, 7)
    bound, bound_by = bound_ms(union.lv, k, 4, True)
    # the plain version and the scatter_reduce yardstick on the same
    # inputs: one warm-up call and one timed call each
    base = [base_matrix(union.lv, k, 7, torch.float32, True)]
    plain = time_ms(lambda F: level_step_plain(
        union.lv, F, clamp=False, R_out=torch.zeros_like(F)), base,
        warmup=1)
    lib = time_ms(lambda F: library_version(
        union.lv, F, False, torch.zeros_like(F)), base, warmup=1)
    Fk, Fl = base[0].clone(), base[0].clone()
    level_step(union.lv, Fk, clamp=False)
    library_version(union.lv, Fl, False)
    torch.cuda.synchronize()
    if not bits_equal(Fk, Fl):
        raise SystemExit("scatter_reduce yardstick disagrees on the union")
    out = dict(union=dict(ms=ms, launches_per_call=grids,
                          levels_per_call=levels,
                          us_per_level=1e3 * ms / max(levels, 1),
                          plain_ms=plain, library_ms=lib,
                          bound_ms=bound, bound_by=bound_by, n=union.lv.n,
                          levels=union.lv.n_levels, k=k))
    ms = grids = levels = 0.0
    for m, cs in pairs:
        for g in suite.members:
            t, n, lvl = timed(replay_plan(g, m, cs).lv, 7)
            ms, grids, levels = ms + t, grids + n, levels + lvl
    out["members"] = dict(plans=len(pairs) * len(suite.members), ms=ms,
                          launches_per_call=grids, levels_per_call=levels,
                          us_per_level=1e3 * ms / max(levels, 1))
    return out


def check_equal(got, want, label: str) -> None:
    """``got`` (arrays, dicts, lists) equal to the fixture's values, every
    float exactly."""
    from suite_expected import plain    # as the fixture was written
    diff = same(json.loads(json.dumps(plain(got))), want, label)
    if diff:
        raise SystemExit(f"{label} differs from the JAX package's:\n" +
                         "\n".join(diff[:20]))


class k1_counts:
    """K1's grids, levels and calls inside the block, and its seconds."""

    def __enter__(self):
        import torch
        from repro_torch.kernels.level_step import level_step
        torch.cuda.synchronize()
        self.k, self.t0 = level_step, time.perf_counter()
        self.n0 = (level_step.launches, level_step.levels, level_step.calls)
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        k = self.k
        self.grids, self.levels, self.calls = (
            k.launches - self.n0[0], k.levels - self.n0[1],
            k.calls - self.n0[2])
        return False

    def row(self) -> dict:
        return dict(seconds=self.seconds, k1_grids=self.grids,
                    k1_levels=self.levels, k1_calls=self.calls)


def fallbacks(want: int, label: str) -> int:
    """The suite's fallback points since the last check (then reset),
    which must be the JAX package's count on the same grid: a level kernel
    that is wrong on a union plan fails certification, and the per-member
    fallback would answer those points correctly from member plans."""
    from repro_torch.core import suite as SU
    got = SU.stats["fallback_points"]
    SU.stats.reset()
    if got != want:
        raise SystemExit(f"suite grid ({label}): {got} fallback points, "
                         f"the JAX package's run {want}")
    return got


#: the members of phase "suite" (c)'s class-vector grid, of PAPER_15's
#: 15: the seven smallest (33,120 of 554,380 vertices), gemver (9
#: objects, the rows' width) among them; each member's blocks are
#: certified on their own, so the suite falls back at the sum of the
#: fixture's ``fallback_points_by_member`` (PERF.md §4)
CLASS_MEMBERS = ("atax", "bicg", "mvt", "gemver", "gesummv", "lu",
                 "trisolv")
#: the traces of phase "suite" (d), of the fixture's 16: oracle and
#: greedy on small PolyBench traces, greedy alone on gemver (9 objects),
#: HPCG's CG solve; the six largest PolyBench traces (2mm, 3mm, doitgen,
#: gemm, symm, syr2k: 6.3M of the 6.9M vertices x 2^objects the oracle
#: passes over the PolyBench traces) are left out for the script's time
#: (PERF.md §4)
PLACEMENT_TRACES = ("atax", "bicg", "mvt", "gemver", "gesummv", "syrk",
                    "trmm", "lu", "trisolv", "hpcg_cg_n8")


def run_suite(expected: dict) -> dict:
    """Phase "suite": the suite and placement path on the card against
    the JAX package's values (``configs/suite_expected.json``).

    (a) ``suite_sweep_grid`` over PAPER_15 at N=20 with the fixture's grid
    (default policy and budget), cold and memo-warm, against the
    per-member ``sweep_grid`` loop (memo-warm) and once more under a
    budget that splits the suite into replay groups and column chunks;
    (b) ``suite_t_inf_sweep`` and ``suite_grid_report(simulate_points=
    True)``; (c) the class-vector grid with each member's
    ``object_class_map`` overlay over the suite of ``CLASS_MEMBERS``; (d)
    ``search_placement`` (oracle where the trace has at most
    ``MAX_ORACLE_OBJECTS`` objects, as ``benchmarks/perf_placement.py``
    does, and greedy) on each of ``PLACEMENT_TRACES``."""
    import numpy as np
    from repro_torch.apps import hpcg, polybench
    from repro_torch.core import (EDagSuite, object_class_map,
                                  objects_from_edag, search_placement,
                                  suite_grid_report, suite_sweep_grid,
                                  suite_t_inf_sweep, sweep_grid)
    from repro_torch.core import backend as B
    from repro_torch.core import scheduler as S
    from repro_torch.core import suite as SU
    from repro_torch.core.placement import MAX_ORACLE_OBJECTS
    from repro_torch.core.plan import REPLAY_BYTES_PER_CELL, ExecPolicy
    cfg = expected["grid_config"]
    alphas = np.asarray(cfg["alphas"])
    ms, css = cfg["ms"], cfg["compute_slots"]
    names = expected["names"]
    out: dict = {}
    t0 = time.perf_counter()
    members = [polybench.trace_kernel(nm, expected["N"]) for nm in names]
    for g in members:
        g._finalize()
    if [g.n_vertices for g in members] != expected["n_vertices"]:
        raise SystemExit("suite: the traces' sizes differ from the JAX "
                         "package's")
    out["trace_s"] = time.perf_counter() - t0
    suite = EDagSuite(members, names=names)
    n_rows = suite.n_vertices * len(ms) * len(css)

    # (a) the union grid, cold, warm, against the member loop
    B.reset_stats()
    S.stats.reset()
    SU.stats.reset()
    with k1_counts() as cold:
        grid = suite_sweep_grid(suite, alphas, ms=ms, compute_slots=css)
    check_equal(grid, expected["grid"], "suite grid (cold)")
    out["cold"] = dict(cold.row(), record_runs=S.stats["record_runs"],
                       record_s=S.stats["record_seconds"],
                       union_plans=SU.stats["plans_built"],
                       fallback_points=fallbacks(
                           expected["grid_fallback_points"], "cold"))
    with k1_counts() as warm:
        grid = suite_sweep_grid(suite, alphas, ms=ms, compute_slots=css)
    out["warm_fallback_points"] = fallbacks(
        expected["grid_fallback_points"], "memo-warm")
    with k1_counts() as loop:
        per_member = np.stack([sweep_grid(g, alphas, ms=ms,
                                          compute_slots=css)
                               for g in members])
    check_equal(grid, expected["grid"], "suite grid (memo-warm)")
    check_equal(per_member, expected["grid"], "per-member sweep_grid")
    out["suite"] = dict(warm.row(), profile=profile_call(
        lambda: suite_sweep_grid(suite, alphas, ms=ms, compute_slots=css)))
    out["loop"] = loop.row()
    out["suite_over_loop"] = loop.seconds / warm.seconds
    out["us_per_level"] = dict(
        suite=1e6 * warm.seconds / max(warm.levels, 1),
        loop=1e6 * loop.seconds / max(loop.levels, 1))
    # a budget that streams the largest member (doitgen) alone and splits
    # the rest into column chunks
    big = max(g.n_vertices for g in members) * len(css)
    pol = ExecPolicy.resolve(
        mem_budget=REPLAY_BYTES_PER_CELL * len(alphas) * (big - 1))
    groups = SU._member_groups(suite, len(css), len(alphas), pol)
    if len(groups) < 2:
        raise SystemExit(f"suite: the split budget made {groups}")
    rows0 = sum(members[i].n_vertices for i in groups[0]) * len(css)
    SU.stats.reset()
    with k1_counts() as split:
        grid = suite_sweep_grid(suite, alphas, ms=ms, compute_slots=css,
                                policy=pol)
    check_equal(grid, expected["grid"], "suite grid (split budget)")
    out["split"] = dict(split.row(), groups=groups,
                        chunk=pol.points_chunk(rows0, len(alphas)),
                        fallback_points=fallbacks(
                            expected["grid_fallback_points"],
                            "split budget"))
    if B.stats["cuda_chunks"] <= 0 or B.stats["cpu_chunks"] != 0:
        raise SystemExit(f"suite replay chunks did not run on the card: "
                         f"{dict(B.stats)}")
    out["replay_stats"] = B.stats.snapshot()
    out["default_chunk"] = ExecPolicy.resolve().points_chunk(
        n_rows // len(ms), len(alphas))

    # (b) the analytic side and the report
    with k1_counts() as rep_t:
        check_equal(suite_t_inf_sweep(suite, alphas), expected["t_inf"],
                    "suite_t_inf_sweep")
        rep = suite_grid_report(suite, alphas, ms=ms, compute_slots=css,
                                simulate_points=True)
    check_equal(rep, expected["report"], "suite_grid_report")
    out["report"] = rep_t.row()

    # (c) the class-vector grid, one overlay per member, over the suite of
    # ``CLASS_MEMBERS``
    want = expected["class_grid"]
    n_obj = []
    for g in members:
        objs = objects_from_edag(g)
        n_obj.append(len(objs))
        g.set_mem_classes(object_class_map(g, objs))
    if n_obj != want["n_objects"]:
        raise SystemExit(f"suite: object counts {n_obj} != the JAX "
                         f"package's {want['n_objects']}")
    pick = [names.index(n) for n in CLASS_MEMBERS]
    S.stats.reset()
    SU.stats.reset()
    with k1_counts() as cls:
        cgrid = suite_sweep_grid(
            EDagSuite([members[i] for i in pick],
                      names=list(CLASS_MEMBERS)),
            np.asarray(want["rows"]), ms=ms, compute_slots=css)
    check_equal(cgrid, [want["grid"][i] for i in pick],
                "class-vector suite grid")
    out["class_grid"] = dict(cls.row(), record_runs=S.stats["record_runs"],
                             record_s=S.stats["record_seconds"],
                             members=list(CLASS_MEMBERS),
                             fallback_points=fallbacks(
                                 sum(want["fallback_points_by_member"][n]
                                     for n in CLASS_MEMBERS),
                                 "class-vector"))
    for g in members:
        g.set_mem_classes(None)

    # (d) the placement search
    pc = expected["placement"]["config"]
    graphs = dict(zip(names, members))
    rows = []
    with k1_counts() as place:
        for tr in expected["placement"]["traces"]:
            if tr["name"] not in PLACEMENT_TRACES:
                continue
            g = graphs.get(tr["name"])
            if g is None:
                g = hpcg.trace_cg(n=expected["placement"]["cg_n"])[0]
            objects = objects_from_edag(g)
            budget = sum(o.nbytes for o in objects) // 2
            if [o.name for o in objects] != tr["objects"] or \
                    budget != tr["budget"]:
                raise SystemExit(f"placement {tr['name']}: objects or "
                                 f"budget differ from the JAX package's")
            reps = {}
            for method in ("oracle", "greedy"):
                if method == "oracle" and len(objects) > MAX_ORACLE_OBJECTS:
                    continue
                r = search_placement(
                    g, pc["alpha_local"], pc["alpha_remote"], budget,
                    objects=objects, m=pc["m"],
                    compute_slots=pc["compute_slots"], method=method)
                reps[method] = r
                check_equal(dict(
                    local=list(r.local), makespan=r.makespan,
                    all_local=r.all_local, all_remote=r.all_remote,
                    budgets=r.budgets, curve=r.curve,
                    curve_local=[list(s) for s in r.curve_local],
                    marginal=r.marginal, lam=[o.lam for o in r.objects]),
                    tr[method], f"placement {tr['name']} {method}")
            gr = reps["greedy"]
            lo = reps["oracle"].makespan if "oracle" in reps else \
                gr.makespan
            if not lo <= gr.makespan <= gr.all_remote:
                raise SystemExit(f"placement {tr['name']}: oracle <= "
                                 f"greedy <= all_remote does not hold")
            rows.append(dict(name=tr["name"], objects=len(objects),
                             methods=sorted(reps), makespan=gr.makespan,
                             all_remote=gr.all_remote))
    out["placement"] = dict(place.row(), traces=len(rows),
                            oracle_traces=sum("oracle" in r["methods"]
                                              for r in rows))
    return out


# --------------------------------------------- persist and service phases

class env_vars:
    """Set environment variables inside the block, restore them after."""

    def __init__(self, **kw: str) -> None:
        self.kw = kw

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kw}
        os.environ.update(self.kw)
        return self

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def scratch_dir(tag: str) -> Path:
    """A fresh directory under the checkout's ``build/`` (git ignores it)
    for this run's schedule caches, trace stores and results."""
    (ROOT / "build").mkdir(exist_ok=True)
    return Path(tempfile.mkdtemp(prefix=f"{tag}-", dir=ROOT / "build"))


def persist_child(cfg_json: str) -> int:
    """One process of the cross-process cache check: trace PolyBench's
    kernel, run ``sweep_grid`` on the card against the cache directory in
    ``$EDAN_SCHEDULE_CACHE``, print one ``PERSIST_CHILD`` JSON line (the
    grid, the cache's counters, K1's counts, seconds)."""
    t_start = time.perf_counter()
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    from repro_torch.apps import polybench
    from repro_torch.core import backend as B
    from repro_torch.core import schedule_cache as sc
    from repro_torch.core import sweep_grid
    from repro_torch.kernels.level_step import level_step
    cfg = json.loads(cfg_json)
    level_step.build()
    t0 = time.perf_counter()
    g = polybench.trace_kernel(cfg["kernel"], cfg["N"])
    g._finalize()
    g._sim_lists()
    trace_s = time.perf_counter() - t0
    sc.reset_stats()
    B.reset_stats()
    level_step.reset_counts()
    t0 = time.perf_counter()
    grid = sweep_grid(g, np.asarray(cfg["alphas"]), ms=cfg["ms"],
                      compute_slots=cfg["compute_slots"])
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    print("PERSIST_CHILD " + json.dumps(dict(
        grid=grid.tolist(), digest=g.trace_digest(),
        n_vertices=g.n_vertices, trace_s=trace_s, grid_s=grid_s,
        process_s=time.perf_counter() - t_start,
        cache=sc.stats.snapshot(), replay=B.stats.snapshot(),
        k1=dict(launches=level_step.launches, levels=level_step.levels,
                calls=level_step.calls))), flush=True)
    return 0


def run_persist_children(cfg: dict, cache: Path) -> dict:
    """``perf_core.py``'s cross-process protocol: two cold children (the
    first seeds ``cache/shared``, the second records into a fresh
    directory) and two warm children on ``cache/shared``, one after the
    other.  Cold children must record, warm ones record nothing and spend
    no recording seconds, and every grid must equal the fixture's."""
    runs = {}
    want = {k: cfg[k] for k in ("kernel", "N", "alphas", "ms",
                                "compute_slots")}
    for label, d in (("cold0", "shared"), ("cold1", "cold1"),
                     ("warm0", "shared"), ("warm1", "shared")):
        env = dict(os.environ, EDAN_SCHEDULE_CACHE=str(cache / d),
                   EDAN_SCHEDULE_CACHE_MIN="0",
                   EDAN_SCHEDULE_CACHE_MAX=str(10 ** 6),
                   EDAN_TORCH_BACKEND="cuda")
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             f"sys.exit(chip_smoke.persist_child({json.dumps(want)!r}))"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        line = next((ln for ln in p.stdout.splitlines()
                     if ln.startswith("PERSIST_CHILD ")), None)
        if p.returncode != 0 or line is None:
            sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
            raise SystemExit(f"persist child {label} exited "
                             f"{p.returncode}")
        got = json.loads(line[len("PERSIST_CHILD "):])
        check_equal(got.pop("grid"), cfg["grid"], f"gemm grid ({label})")
        if got["digest"] != cfg["digest"]:
            raise SystemExit(f"gemm {label}: digest differs from the JAX "
                             f"package's")
        st, rp = got["cache"], got["replay"]
        if rp["cuda_chunks"] <= 0 or rp["cpu_chunks"] != 0 or \
                got["k1"]["launches"] <= 0:
            raise SystemExit(f"gemm {label} did not replay on the card: "
                             f"{rp} {got['k1']}")
        if label.startswith("cold") and not (st["record_runs"] > 0 and
                                             st["stores"] > 0):
            raise SystemExit(f"gemm {label} recorded nothing: {st}")
        if label.startswith("warm") and not (
                st["record_runs"] == 0 and st["record_seconds"] == 0 and
                st["disk_hits"] == len(cfg["ms"]) *
                len(cfg["compute_slots"])):
            raise SystemExit(f"gemm {label} did not warm from the disk: "
                             f"{st}")
        runs[label] = dict(got, wall_s=wall)
    return runs


def run_persist(expected: dict) -> dict:
    """Phase "persist": (1) the gemm children (``run_persist_children``);
    (2) HPCG CG at ``perf_scale.py``'s "1m" tier under a 64 MiB replay
    budget: trace, ``sweep_grid`` on the card (recording, stored as a
    format-4 entry), ``save_edag``, drop the graph, ``load_edag`` (memory
    maps, digest-verified), ``sweep_grid`` again from the mapped trace and
    the mapped entry; both grids the JAX package's; (3) the "100k" tier
    through the legacy list build: its digest, edges, levels and sweep
    row the streaming build's and the JAX package's."""
    cache = scratch_dir("persist")
    try:
        return persist_scenarios(expected, cache)
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def persist_scenarios(expected: dict, cache: Path) -> dict:
    import gc
    import numpy as np
    import torch
    from repro_torch.apps import hpcg
    from repro_torch.core import backend as B
    from repro_torch.core import load_edag, save_edag, sweep_grid
    from repro_torch.core import schedule_cache as sc
    out = dict(gemm=run_persist_children(expected["gemm"], cache))
    cfg = expected["hpcg"]
    alphas = np.asarray(cfg["alphas"])
    kw = dict(ms=cfg["ms"], compute_slots=cfg["compute_slots"])
    with env_vars(EDAN_SCHEDULE_CACHE=str(cache / "hpcg"),
                  EDAN_REPLAY_MEM_BUDGET=str(cfg["mem_budget"])):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g = hpcg.trace_cg(n=cfg["n"], iters=cfg["iters"])[0]
        g._finalize()
        trace_s = time.perf_counter() - t0
        if (g.n_vertices, g.n_edges, g.n_levels, g.trace_digest()) != (
                cfg["n_vertices"], cfg["n_edges"], cfg["n_levels"],
                cfg["digest"]):
            raise SystemExit("hpcg: the trace differs from the JAX "
                             "package's")
        sc.reset_stats()
        B.reset_stats()
        with k1_counts() as cold:
            grid = sweep_grid(g, alphas, **kw)
        check_equal(grid, cfg["grid"], "hpcg grid (cold)")
        cold_st = sc.stats.snapshot()
        entries = sorted(p.name for p in (cache / "hpcg").glob("*.d"))
        if cold_st["record_runs"] < 1 or not entries:
            raise SystemExit(f"hpcg: no format-4 entry stored: {cold_st}")
        t0 = time.perf_counter()
        path = save_edag(g, cache / "trace")
        save_s = time.perf_counter() - t0
        del g
        gc.collect()
        t0 = time.perf_counter()
        g2 = load_edag(path)
        load_s = time.perf_counter() - t0
        sc.reset_stats()
        with k1_counts() as warm:
            grid2 = sweep_grid(g2, alphas, **kw)
        check_equal(grid2, cfg["grid"], "hpcg grid (mapped reload)")
        warm_st = sc.stats.snapshot()
        if warm_st["disk_hits"] < 1 or warm_st["record_runs"] != 0:
            raise SystemExit(f"hpcg: the reload re-recorded: {warm_st}")
        if B.stats["cuda_chunks"] <= 0 or B.stats["cpu_chunks"] != 0:
            raise SystemExit(f"hpcg replay chunks off the card: "
                             f"{dict(B.stats)}")
        chunks = B.stats["chunks"]
        del g2
        peak = torch.cuda.max_memory_allocated()
    lc = expected["legacy"]
    t0 = time.perf_counter()
    gs = hpcg.trace_cg(n=lc["n"], iters=lc["iters"])[0]
    with env_vars(EDAN_LEGACY_BUILD="1"):
        gl = hpcg.trace_cg(n=lc["n"], iters=lc["iters"])[0]
    if not gl._legacy or gs._legacy:
        raise SystemExit("the legacy build knob was not honoured")
    for gx in (gs, gl):
        gx._finalize()
        if (gx.n_vertices, gx.n_edges, gx.n_levels, gx.trace_digest()) != (
                lc["n_vertices"], lc["n_edges"], lc["n_levels"],
                lc["digest"]):
            raise SystemExit("100k tier: a build differs from the JAX "
                             "package's trace")
    if not (np.array_equal(gs.src, gl.src) and
            np.array_equal(gs.dst, gl.dst) and
            np.array_equal(gs.level, gl.level)):
        raise SystemExit("100k tier: legacy and streaming builds differ")
    with env_vars(EDAN_SCHEDULE_CACHE="off"):
        for label, gx in (("streaming", gs), ("legacy", gl)):
            check_equal(sweep_grid(gx, alphas, **kw), lc["grid"],
                        f"100k tier sweep ({label} build)")
    legacy_s = time.perf_counter() - t0
    out["hpcg"] = dict(
        n_vertices=cfg["n_vertices"], n_levels=cfg["n_levels"],
        trace_s=trace_s, cold=dict(cold.row(), cache=cold_st),
        save_s=save_s, load_s=load_s,
        warm=dict(warm.row(), cache=warm_st), entries=entries,
        replay_chunks=chunks, peak_device_gib=peak / 2 ** 30)
    out["legacy_s"] = legacy_s
    return out


def percentiles_ms(lat_s) -> tuple:
    import numpy as np
    lat = np.asarray(sorted(lat_s)) * 1e3
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


def service_waves(c: dict, n_waves: int, wave: int) -> list:
    """``perf_service.py``'s stream: waves of compatible requests, the
    kernels in turn."""
    from repro_torch.serve import AnalysisRequest
    names = c["kernels"]
    return [[AnalysisRequest(kernel=names[(w * wave + k) % len(names)],
                             n=c["N"], alphas=tuple(c["alphas"]),
                             ms=tuple(c["ms"]),
                             compute_slots=tuple(c["compute_slots"]),
                             deadline_s=c["deadline_s"])
             for k in range(wave)] for w in range(n_waves)]


def check_results(results, want_outcomes, reports, label: str) -> None:
    """Each result's outcome and (when ok) report equal to the JAX
    package's run of the same stream."""
    from service_expected import outcome    # as the fixture was written
    got = [outcome(r) for r in results]
    diff = same(got, want_outcomes, label)
    if diff:
        raise SystemExit(f"{label}: outcomes differ from the JAX "
                         f"package's:\n" + "\n".join(diff[:20]))
    for r in results:
        if r.ok:
            check_equal(r.report, reports[r.report["name"]],
                        f"{label} report {r.rid}")


def drive_stream(c: dict, spec: str = "") -> tuple:
    """The stream through one service, a wave per ``process`` call;
    returns (results, the scenario's row)."""
    from repro_torch.serve import AnalysisService, faults
    faults.reset()
    for s in faults.parse_spec(spec):
        faults.install(s.stage, s.kind, count=s.count, every=s.every,
                       delay=s.delay, rid=s.rid, min_batch=s.min_batch)
    service = AnalysisService(start=False, backoff_s=c["backoff_s"])
    results, lat = [], []
    t0 = time.perf_counter()
    for wave in service_waves(c, c["n_waves"], c["wave"]):
        tw = time.perf_counter()
        out = service.process(wave)
        lat.extend([(time.perf_counter() - tw) / len(out)] * len(out))
        results.extend(out)
    seconds = time.perf_counter() - t0
    fired = dict(faults.fire_log)
    faults.reset()
    p50, p99 = percentiles_ms(lat)
    return results, dict(requests=len(results), seconds=seconds,
                         rps=len(results) / seconds, p50_ms=p50, p99_ms=p99,
                         success_rate=sum(r.ok for r in results) /
                         len(results),
                         retries=sum(r.retries for r in results),
                         fired={f"{k[0]}:{k[1]}": v
                                for k, v in fired.items()})


def run_service(expected: dict) -> dict:
    work = scratch_dir("service")
    try:
        with env_vars(EDAN_SCHEDULE_CACHE=str(work / "sched")):
            return service_scenarios(expected, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def service_scenarios(expected: dict, work: Path) -> dict:
    """Phase "service": ``perf_service.py``'s streams through the port's
    ``AnalysisService`` on the card, against the JAX package's run of the
    same streams (``configs/service_expected.json``): the clean stream
    (every request on rung 0, ``("cuda", None)``, K1 on the card
    only), the transient stream, the poisoned wave, a ``kernel`` fault
    (the request ends one rung down on ``("cuda", "float64")``, stored as
    JSON), a ``cache`` fault (the corrupted entry quarantined and
    re-recorded), one wave through the admission thread, and one profiled
    clean wave."""
    from repro_torch.core import backend as B
    from repro_torch.core import schedule_cache as sc
    from repro_torch.core.plan import ExecPolicy
    from repro_torch.serve import AnalysisService, faults
    c, reports = expected["config"], expected["reports"]
    rung0 = ExecPolicy.resolve().ladder()[0]
    if (rung0.backend, rung0.replay_dtype) != ("cuda", None):
        raise SystemExit(f"the default policy's first rung is {rung0}")
    out: dict = {}

    B.reset_stats()
    with k1_counts() as k1:
        clean, row = drive_stream(c)
    check_results(clean, expected["clean"], reports, "clean stream")
    off_rung0 = [r.rid for r in clean if
                 (r.policy["backend"], r.policy["replay_dtype"]) !=
                 ("cuda", None) or r.policy["demotions"] != 0]
    if off_rung0:
        raise SystemExit(f"clean requests {off_rung0} left rung 0")
    if B.stats["cuda_chunks"] <= 0 or B.stats["cpu_chunks"] != 0:
        raise SystemExit(f"clean stream replays off the card: "
                         f"{dict(B.stats)}")
    out["clean"] = dict(row, k1=k1.row(), replay=B.stats.snapshot())

    faulty, row = drive_stream(c, c["transient_spec"])
    check_results(faulty, expected["faulty"], reports, "transient stream")
    if row["success_rate"] != 1.0:
        raise SystemExit(f"transient stream: success {row['success_rate']}")
    out["transient"] = row

    faults.reset()
    faults.install("replay", "backend", min_batch=2)
    faults.install("replay", "backend", rid=1)
    pois = AnalysisService(start=False, backoff_s=0.0).process(
        service_waves(c, 1, c["poisoned_wave"])[0])
    faults.reset()
    check_results(pois, expected["poisoned"], reports, "poisoned wave")
    healthy = [r for r in pois if r.rid != 1]
    out["poisoned"] = dict(
        healthy_success_rate=sum(r.ok for r in healthy) / len(healthy),
        poisoned_success_rate=float(pois[1].ok),
        poisoned_error=pois[1].error["code"])
    if out["poisoned"]["healthy_success_rate"] != 1.0 or pois[1].ok:
        raise SystemExit(f"poisoned wave: {out['poisoned']}")

    kernel = c["cache_fault_kernel"]
    (one,) = service_waves(dict(c, kernels=[kernel]), 1, 1)[0]
    faults.install("kernel", "backend", count=1)
    try:
        (res,) = AnalysisService(start=False, backoff_s=0.0,
                                 results_dir=work / "results").process(
            [one])
        fired = faults.fire_log.get(("kernel", "backend"), 0)
    finally:
        faults.reset()
    if not res.ok or fired != 1 or res.policy != {
            "backend": "cuda", "replay_dtype": "float64",
            "demotions": 1} or res.stored is not True:
        raise SystemExit(f"kernel fault: ok={res.ok} fired={fired} "
                         f"policy={res.policy} stored={res.stored} "
                         f"error={res.error}")
    check_equal(res.report, reports[kernel], "kernel-fault report")
    doc = json.loads((work / "results" / f"result_{res.rid}.json")
                     .read_text())
    check_equal(doc["report"], reports[kernel], "stored kernel-fault report")
    out["kernel_fault"] = dict(policy=res.policy, retries=res.retries,
                               stored=res.stored)

    cf = expected["cache_fault"]
    with env_vars(EDAN_SCHEDULE_CACHE_MIN="0"):
        sc.clear()
        AnalysisService(start=False, backoff_s=0.0).process(
            service_waves(dict(c, kernels=[kernel]), 1, 1)[0])
        sc.reset_stats()
        faults.install("cache-load", "cache", count=1)
        (res,) = AnalysisService(start=False, backoff_s=0.0).process(
            service_waves(dict(c, kernels=[kernel]), 1, 1)[0])
        faults.reset()
        st = {k: v for k, v in sc.stats.items() if k != "record_seconds"}
    bad = sorted(p.name for p in (work / "sched").glob("*.bad"))
    if st != cf["stats"] or not bad:
        raise SystemExit(f"cache fault: stats {st} (the JAX package's "
                         f"{cf['stats']}), quarantined {bad}")
    check_results([res], [{k: cf[k] for k in ("ok", "retries", "demotions",
                                               "batch", "error")}],
                  reports, "cache-fault request")
    out["cache_fault"] = dict(stats=st, quarantined=bad)

    wave = service_waves(c, 1, c["wave"])[0]
    service = AnalysisService(batch_window_s=0.05, backoff_s=0.0)
    try:
        threaded = service.run(wave, timeout=300.0)
    finally:
        service.close()
    check_results(threaded, expected["clean"][:c["wave"]], reports,
                  "admission thread")
    service = AnalysisService(start=False, backoff_s=0.0)
    prof = profile_call(lambda: service.process(
        service_waves(c, 1, c["wave"])[0]))
    out["profile_clean_wave"] = prof
    return out


# ----------------------------------------------------------- frontend phase

def jsonable(x):
    return json.loads(json.dumps(x))


def hlo_checks(expected: dict) -> dict:
    """(a) Each HLO fixture through the port's parser and analyses, equal
    to the JAX package's results (``frontend_expected.json``)."""
    import gzip
    from repro_torch.core import (analyze_collectives, collective_sensitivity,
                                  hlo_flops_estimate, hlo_hbm_bytes_estimate)
    out = {}
    for name, want in sorted(expected["hlo"].items()):
        text = gzip.decompress((SRC / "repro_torch" / "configs" / "hlo" /
                                f"{name}.hlo.gz").read_bytes()).decode()
        axes = [tuple(a) for a in want["mesh_axes"]]
        with k1_counts() as k1:
            coll = analyze_collectives(text, axes)
            flops = hlo_flops_estimate(text)
            hbm = hlo_hbm_bytes_estimate(text)
            sens = collective_sensitivity(text, axes,
                                          m=expected["config"]["sens_m"])
        sens = dict(per_axis={k: v.row() for k, v in
                              sens["per_axis"].items()}, raw=sens["raw"])
        for label, got, exp in (
                ("analyze_collectives", coll, want["analyze_collectives"]),
                ("flops", flops, want["flops"]),
                ("hbm_bytes", hbm, want["hbm_bytes"]),
                ("collective_sensitivity", sens,
                 want["collective_sensitivity"])):
            if jsonable(got) != exp:
                raise SystemExit(f"HLO {name}: {label} {got} is not the JAX "
                                 f"package's {exp}")
        out[name] = dict(k1.row(), text_bytes=len(text.encode()),
                         collectives=coll["total"]["count"],
                         depth=coll["total"]["depth"])
        print(f"  hlo {name}: {json.dumps(out[name])}", flush=True)
    return out


def rel_err_np(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def timed_ms(fn) -> tuple:
    """(result, ms) of one call, after a synchronise on each side."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def run_twins(size: dict) -> dict:
    """(b) The twins in float64 on the card, held to numpy (PolyBench
    1e-12, CG's residual history 1e-10) and LULESH to its run on the host
    (1e-12); milliseconds of a first and a second call."""
    import torch
    from repro_torch.apps import hpcg, lulesh, polybench
    out = {}
    for name, fn in polybench.TORCH_KERNELS.items():
        args = polybench.twin_inputs(name, size["polybench_N"])
        dev = [torch.from_numpy(a).to("cuda") for a in args]
        _, first = timed_ms(lambda: fn(*dev))
        res, ms = timed_ms(lambda: fn(*dev))
        res = res if isinstance(res, tuple) else (res,)
        err = max(rel_err_np(r.cpu().numpy(), w) for r, w in
                  zip(res, polybench.twin_numpy(name, args)))
        if not err <= 1e-12:
            raise SystemExit(f"twin {name} on the card: relative error {err}")
        out[name] = dict(ms=ms, first_ms=first, rel_err=err)
    n, iters = size["hpcg_n"], size["hpcg_iters"]
    b = torch.from_numpy(hpcg.build_problem(n, size["seed"])).to("cuda")
    _, first = timed_ms(lambda: hpcg.cg_torch(b, n, iters))
    (_, hist), ms = timed_ms(lambda: hpcg.cg_torch(b, n, iters))
    err = rel_err_np(hist.cpu().numpy(),
                     hpcg.reference_solution(n, iters, size["seed"])[1])
    if not err <= 1e-10:
        raise SystemExit(f"CG twin on the card: residual history relative "
                         f"error {err}")
    out["cg"] = dict(ms=ms, first_ms=first, rel_err=err)
    ne, iters = size["lulesh_ne"], size["lulesh_iters"]
    _, first = timed_ms(lambda: lulesh.run_torch(ne, iters, size["seed"],
                                                 "cuda"))
    (st, hist), ms = timed_ms(lambda: lulesh.run_torch(ne, iters,
                                                       size["seed"], "cuda"))
    got = [a.cpu().numpy() for a in st + (hist,)]
    ref_st, ref_hist = lulesh.lulesh_numpy(ne, iters, size["seed"])
    err = max(rel_err_np(a, r) for a, r in zip(got, ref_st + (ref_hist,)))
    host_st, host_hist = lulesh.run_torch(ne, iters, size["seed"], "cpu")
    host_err = max(rel_err_np(a, h.numpy())
                   for a, h in zip(got, host_st + (host_hist,)))
    if not (err <= 1e-12 and host_err <= 1e-12):
        raise SystemExit(f"LULESH twin on the card: relative error {err} "
                         f"from numpy, {host_err} from the host run")
    out["lulesh"] = dict(ms=ms, first_ms=first, rel_err=err,
                         host_rel_err=host_err)
    for name, row in out.items():
        print(f"  twin {name} on the card: {json.dumps(row)}", flush=True)
    return out


def trace_twins(size: dict) -> dict:
    """The twins' eDAGs, traced abstractly from float32 arguments on the
    card (nothing runs), with seconds to trace."""
    import numpy as np
    import torch
    from repro_torch.apps import hpcg, lulesh, polybench
    from repro_torch.core import edag_from_fn
    cuda = lambda a: torch.empty(np.shape(a), dtype=torch.float32,  # noqa
                                 device="cuda")
    jobs = {name: (fn, [cuda(a) for a in polybench.twin_inputs(
        name, size["polybench_N"])])
        for name, fn in polybench.TORCH_KERNELS.items()}
    n, iters = size["hpcg_n"], size["hpcg_iters"]
    jobs["cg"] = (lambda b: hpcg.cg_torch(b, n, iters),
                  [cuda(hpcg.build_problem(n))])
    ne, steps = size["lulesh_ne"], size["lulesh_iters"]
    step = lulesh.make_torch_step(ne, "cuda")
    jobs["lulesh"] = (lambda *s: lulesh.run_steps(step, s, steps),
                      [cuda(a) for a in lulesh.initial_state(ne)])
    out = {}
    for name, (fn, args) in jobs.items():
        t0 = time.perf_counter()
        g = edag_from_fn(fn, *args)
        g.trace_digest()
        out[name] = (g, time.perf_counter() - t0)
    return out


def run_frontend(expected: dict) -> dict:
    """Phase "frontend": (a) the HLO fixtures, (b) the twins on the card,
    (c) their eDAGs traced and analysed on the card (report and sweep grid
    under ``("cuda", "float32")``, every value the JAX package's, no chunk
    on the host).  K1's kernel-vs-plain check (d) runs after, outside the
    counted run."""
    # as the fixture was written
    from frontend_expected import MUST_AGREE, agreeing, plain, summary
    from repro_torch.core import backend as B
    from repro_torch.core import report, sweep_grid
    from repro_torch.core.plan import ExecPolicy
    size, grid = expected["config"]["twins"], expected["config"]["grid"]
    out = dict(hlo=hlo_checks(expected), twins=run_twins(size))
    policy = ExecPolicy.resolve(backend="cuda", replay_dtype="float32")
    agree = agreeing(expected)
    missing = sorted(set(MUST_AGREE) - set(agree))
    if missing:
        raise SystemExit(f"the fixture's twins {missing} differ from the "
                         f"JAX package's")
    B.reset_stats()
    traced = {}
    for name, (g, secs) in trace_twins(size).items():
        got = summary(g)
        if got != {k: expected["port_twins"][name][k] for k in got}:
            raise SystemExit(f"twin {name}: the eDAG traced here differs "
                             f"from the recorded one: {got['vertices']} "
                             f"vertices, digest {got['digest']}")
        ref = expected["reference_twins"][name]
        if name in agree and got != ref:
            raise SystemExit(f"twin {name}: the eDAG differs from the JAX "
                             f"package's ({ref['vertices']} vertices)")
        with k1_counts() as k1:
            rep = jsonable(plain(vars(report(g))))
            sg = sweep_grid(g, grid["alphas"], ms=grid["ms"],
                            compute_slots=grid["compute_slots"],
                            policy=policy)
        want = expected["port_twins"][name]
        if rep != want["report"]:
            raise SystemExit(f"twin {name}: report {rep} is not the JAX "
                             f"package's {want['report']}")
        if sg.tolist() != want["sweep_grid"]:
            raise SystemExit(f"twin {name}: sweep grid differs from the JAX "
                             f"package's")
        traced[name] = dict(vertices=got["vertices"], edges=got["edges"],
                            levels=int(g._level_csr().n_levels),
                            trace_s=secs, reference_vertices=ref["vertices"],
                            same_as_reference=got == ref, **k1.row())
        print(f"  frontend {name}: {json.dumps(traced[name])}", flush=True)
    if B.stats["cuda_chunks"] <= 0 or B.stats["cpu_chunks"] != 0:
        raise SystemExit(f"frontend analyses off the card: {dict(B.stats)}")
    out.update(traced=traced, replay=B.stats.snapshot())
    return out


def frontend_kernel_checks(size: dict) -> tuple:
    """(d) K1 against its plain version, bitwise, on the CG twin's eDAG
    and its replay plan (m=4, 8 ALU slots)."""
    import numpy as np
    import torch
    from repro_torch.apps import hpcg
    from repro_torch.core import edag_from_fn
    n, iters = size["hpcg_n"], size["hpcg_iters"]
    g = edag_from_fn(lambda b: hpcg.cg_torch(b, n, iters),
                     torch.empty(n ** 3, device="meta"))
    k = len(np.linspace(50.0, 300.0, 13))
    n_cases, err = 0, 0.0
    for lv, seed, label in ((g._level_csr(), 21, "CG twin DAG"),
                            (replay_plan(g, 4, 8).lv, 22,
                             "CG twin replay m=4 cs=8")):
        c, e = check_kernel(lv, k, seed, label)
        n_cases, err = n_cases + c, max(err, e)
    return n_cases, err


# --------------------------------------------------------------- zoo phase

def zoo_traces(c: dict, expected: dict) -> tuple:
    """(a) Every reduced model trace of the fixture (each ``ZOO`` config's
    prefill and decode, the train phase of ``c["train"]``) through
    ``trace_model`` into the phase's trace store: vertices, edges, levels
    and seconds, each trace the recorded one; then the full-width trace
    ``c["full"]`` at ``c["full_layers"]`` layers, timed and held to its
    record."""
    import dataclasses
    from zoo_expected import summary    # as the fixture was written
    from repro_torch.configs import get_config
    from repro_torch.models import tracing
    jobs = [(n, ph) for n in c["zoo"].values() for ph in ("prefill", "decode")]
    jobs += [(n, "train") for n in c["train"]]
    graphs, rows = {}, {}
    for name, phase in jobs:
        key = f"{name}:{phase}"
        t0 = time.perf_counter()
        g = tracing.trace_model(name, phase)
        secs = time.perf_counter() - t0
        got = summary(g)
        if got != expected["port_traces"][key]:
            raise SystemExit(f"trace {key}: {got} is not the recorded "
                             f"{expected['port_traces'][key]}")
        graphs[key] = g
        rows[key] = dict(vertices=got["vertices"], edges=got["edges"],
                         levels=int(g._level_csr().n_levels), trace_s=secs)
        print(f"  zoo {key}: {json.dumps(rows[key])}", flush=True)
    t0 = time.perf_counter()
    arch, ph = c["full"]
    full = tracing.trace_model(
        dataclasses.replace(get_config(arch), n_layers=c["full_layers"]), ph,
        use_store=False)
    secs = time.perf_counter() - t0
    got = summary(full)
    if got != expected["full_trace"]:
        raise SystemExit(f"full-width trace {c['full']}: {got} is not the "
                         f"recorded {expected['full_trace']}")
    rows[":".join(c["full"]) + ":full"] = dict(
        vertices=got["vertices"], edges=got["edges"],
        levels=int(full._level_csr().n_levels), trace_s=secs)
    print(f"  zoo {c['full']} at full width: {got['vertices']} vertices "
          f"in {secs:.2f} s", flush=True)
    return graphs, rows


def zoo_service(c: dict, want: dict) -> dict:
    """(c) The model requests through the port's ``AnalysisService``: a
    clean one and a union batch of three on rung 0 ``("cuda", None)``,
    a transient and a hard ``trace-model`` fault; every outcome the JAX
    package's and every report its analysis of the same eDAG."""
    from repro_torch.core import backend as B
    from repro_torch.serve import AnalysisRequest, AnalysisService, faults
    sv = c["service"]

    def requests(names, **kw):
        return [AnalysisRequest(config=n, kind="model", phase=sv["phase"],
                                alphas=tuple(sv["alphas"]),
                                ms=tuple(sv["ms"]),
                                compute_slots=tuple(sv["compute_slots"]),
                                **kw) for n in names]

    def run(reqs, fault=None):
        faults.reset()
        if fault is not None:
            faults.install("trace-model", "io", **fault)
        try:
            return AnalysisService(start=False, backoff_s=0.0).process(reqs)
        finally:
            faults.reset()

    one, union = sv["union"][:1], sv["union"]
    B.reset_stats()
    with k1_counts() as k1:
        clean, batch = run(requests(one)), run(requests(union))
    check_results(clean, want["clean"], want["reports"], "model request")
    check_results(batch, want["union"], want["reports"], "model union")
    off = [r.rid for r in clean + batch if (r.policy["backend"],
           r.policy["replay_dtype"], r.policy["demotions"]) !=
           ("cuda", None, 0)]
    if off or B.stats["cuda_chunks"] <= 0 or B.stats["cpu_chunks"] != 0:
        raise SystemExit(f"model requests {off} off rung 0, replays "
                         f"{dict(B.stats)}")
    out = dict(clean=dict(k1.row(), replay=B.stats.snapshot()))
    transient = run(requests(one), dict(count=1))
    check_results(transient, want["transient"], want["reports"],
                  "transient trace-model fault")
    hard = run(requests(one, max_retries=sv["max_retries_hard"]), {})
    check_results(hard, want["hard"], want["reports"],
                  "hard trace-model fault")
    if hard[0].error["stage"] != "trace-model":
        raise SystemExit(f"hard trace-model fault: {hard[0].error}")
    out.update(transient_retries=transient[0].retries,
               hard_error=hard[0].error["code"])
    print(f"  zoo service: {json.dumps(out)}", flush=True)
    return out


def run_zoo(expected: dict) -> tuple:
    """Phase "zoo": the model-zoo tracing path on the card against
    ``configs/zoo_expected.json``: (a) ``zoo_traces``; (b)
    ``model_grid_report`` over the six prefill traces (from the phase's
    trace store), 13 alphas x m (2, 4, 8) x (0, 8) ALU slots under
    ``("cuda", "float32")``, every value the JAX package's analysis of the
    same eDAGs, no replay chunk on the host; (c) ``zoo_service``.  Returns
    (the phase's rows, the traces)."""
    from repro_torch.core import backend as B
    from repro_torch.core.plan import ExecPolicy
    from repro_torch.models import tracing
    c = expected["config"]
    work = scratch_dir("zoo")
    try:
        with env_vars(EDAN_TRACE_STORE=str(work / "traces")):
            graphs, rows = zoo_traces(c, expected)
            grid = c["grid"]
            B.reset_stats()
            with k1_counts() as k1:
                rep = tracing.model_grid_report(
                    expected["grid"]["names"], grid["alphas"], "prefill",
                    ms=tuple(grid["ms"]),
                    compute_slots=tuple(grid["compute_slots"]),
                    policy=ExecPolicy.resolve(backend="cuda",
                                              replay_dtype="float32"))
            check_equal(rep, expected["grid"], "model grid report")
            if B.stats["cuda_chunks"] <= 0 or B.stats["cpu_chunks"] != 0:
                raise SystemExit(f"model grid off the card: {dict(B.stats)}")
            out = dict(traces=rows, grid=dict(k1.row(),
                                              replay=B.stats.snapshot()))
            print(f"  zoo grid: {json.dumps(out['grid'])}", flush=True)
            out["service"] = zoo_service(c, expected["service"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out, graphs


# ------------------------------------------------------ serving phases

def kernel_wrappers() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.level_step import level_step
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    return dict(level_step=level_step, wkv6=wkv6, ssd=ssd,
                flash_attention=flash_attention)


def reset_counts() -> None:
    for k in kernel_wrappers().values():
        k.reset_counts()


def read_counts() -> dict:
    return {n: k.launches for n, k in kernel_wrappers().items()}


def plain_attention(q, k, v, *, causal=True, window=0, block_q=128,
                    block_kv=128):
    """What ``ops.flash_attention`` runs for CPU tensors (the models' plain
    path), on the card."""
    from repro_torch.models.layers import attention_ref
    return attention_ref(q, k, v, causal=causal, window=window,
                         chunk_kv=block_kv)


class plain_kernels:
    """Within the block the models' kernels take their plain versions on
    the card: the chunked recurrences and ``attention_ref`` (for the
    kernel-vs-plain comparison of a whole prefill), or with
    ``sequential`` the recurrences' sequential forms, the exact oracle."""

    def __init__(self, sequential: bool = False):
        self.sequential = sequential

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.saved = ops.wkv6, ops.ssd, ops.flash_attention
        if self.sequential:
            ops.wkv6 = lambda *a, chunk=64: ref.wkv6_ref(*a)
            ops.ssd = lambda *a, chunk=64: ref.ssd_ref(*a)
        else:
            ops.wkv6 = lambda *a, chunk=64: ref.wkv6_chunked_ref(*a,
                                                                 chunk=chunk)
            ops.ssd = lambda *a, chunk=64: ref.ssd_chunked_ref(*a, chunk=chunk)
        ops.flash_attention = plain_attention
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.wkv6, ops.ssd, ops.flash_attention = self.saved
        return False


class finite_watch:
    """Counts the prefill and decode calls made through ``ModelApi`` in the
    block and the non-finite logits they returned."""

    def __enter__(self):
        import torch
        from repro_torch.models import ModelApi
        self.calls, self.nonfinite = 0, 0
        self.saved = ModelApi.prefill_fn, ModelApi.decode_fn

        def watch(fn):
            def inner(api, *a, **kw):
                logits, state = fn(api, *a, **kw)
                self.calls += 1
                self.nonfinite += int((~torch.isfinite(logits)).sum())
                return logits, state
            return inner
        ModelApi.prefill_fn = watch(self.saved[0])
        ModelApi.decode_fn = watch(self.saved[1])
        return self

    def __exit__(self, *exc):
        from repro_torch.models import ModelApi
        ModelApi.prefill_fn, ModelApi.decode_fn = self.saved
        return False


class block_compare:
    """Within the block every block function of ``module`` (the
    ``block_apply`` of ``rwkv6``, ``mamba2`` or ``transformer``;
    ``encdec``'s ``encoder_block`` and ``decoder_block``) runs twice on the
    same inputs, through the kernels and through the plain versions; the
    kernels' result goes on.  Records the largest relative difference of the blocks' output
    hidden states and, for a recurrent block, of their recurrent states.
    The recurrent states are held to the sequential form (a third run of
    the block), the exact recurrence: the chunked plain form's own
    rounding of its cumulative decays over a 128-token chunk reaches ~9e-6
    of the state on zamba2's blocks, most of REC_TOL; the kernels' and the
    chunked form's distances to it are recorded too.  (Comparing only the
    final logits of the two paths measures the random-init model's
    sensitivity instead: in bf16 it amplifies a rounding flip from layer
    to layer.)  With ``against_f32`` each block also runs in float32 (its
    bf16 inputs upcast, the plain versions): the kernels' and the plain
    path's distances to it are recorded, and how far the first exceeds
    the second."""

    def __init__(self, module, recurrent: bool, against_f32: bool = False):
        self.module, self.recurrent = module, recurrent
        self.against_f32 = against_f32
        self.names = [n for n in ("block_apply", "encoder_block",
                                  "decoder_block") if hasattr(module, n)]

    def __enter__(self):
        import torch
        self.saved = {n: getattr(self.module, n) for n in self.names}
        self.blocks, self.worst_h, self.worst_state = 0, 0.0, 0.0
        self.worst_state_chunked, self.chunked_vs_seq = 0.0, 0.0
        self.worst_k_f32, self.worst_p_f32, self.worst_excess = 0.0, 0.0, 0.0

        def f32(a):
            return (a.float() if isinstance(a, torch.Tensor) and
                    a.dtype == torch.bfloat16 else a)

        def both(fn):
            def run(*args):
                out_k = fn(*args)
                with plain_kernels():
                    out_p = fn(*args)
                self.blocks += 1
                self.worst_h = max(self.worst_h, rel_err(out_k[0], out_p[0]))
                if self.against_f32:
                    with plain_kernels():
                        out_f = fn(*map(f32, args))
                    ek, ep = (rel_err(out_k[0], out_f[0]),
                              rel_err(out_p[0], out_f[0]))
                    self.worst_k_f32 = max(self.worst_k_f32, ek)
                    self.worst_p_f32 = max(self.worst_p_f32, ep)
                    self.worst_excess = max(self.worst_excess, ek - ep)
                if self.recurrent:
                    with plain_kernels(sequential=True):
                        out_s = fn(*args)
                    Sk, Sp, Ss = out_k[1]["S"], out_p[1]["S"], out_s[1]["S"]
                    self.worst_state = max(self.worst_state, rel_err(Sk, Ss))
                    self.worst_state_chunked = max(self.worst_state_chunked,
                                                   rel_err(Sk, Sp))
                    self.chunked_vs_seq = max(self.chunked_vs_seq,
                                              rel_err(Sp, Ss))
                return out_k
            return run
        for n, fn in self.saved.items():
            setattr(self.module, n, both(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)
        return False


class attention_compare:
    """Within the block every ``ops.flash_attention`` call runs K4 and the
    plain path's ``attention_ref`` on the same q, k, v; K4's result goes
    on.  Records the calls and the largest relative difference."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.saved = ops.flash_attention
        self.calls, self.worst = 0, 0.0

        def both(q, k, v, **kw):
            o = self.saved(q, k, v, **kw)
            self.calls += 1
            self.worst = max(self.worst, rel_err(o, plain_attention(
                q, k, v, **kw)))
            return o
        ops.flash_attention = both
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention = self.saved
        return False


def run_fixtures(expected: dict) -> list:
    """The fixture configs on the card (float32, two prompts each, 2 slots)
    with the seeded numpy weights: the greedy tokens must equal the JAX
    package's and the prefill logits must agree within 1e-4 of their
    largest magnitude (the port's CPU path measured <= 2e-5 against
    them)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import get_model
    from repro_torch.models.module import init_params_numpy, params_from_numpy
    from repro_torch.serve import Request, ServeEngine, prefill_batch
    out = []
    for fx in expected["fixtures"]:
        cfg = dataclasses.replace(ARCHS[fx["arch"]], **fx["overrides"])
        api = get_model(cfg)
        params = params_from_numpy(init_params_numpy(api.specs(), fx["seed"]),
                                   "cuda")
        eng = ServeEngine(api, params, batch_slots=2,
                          max_seq=fx["prompt_len"] + fx["n_new"])
        reqs = [Request(prompt=r["prompt"], max_tokens=fx["n_new"], rid=i)
                for i, r in enumerate(fx["runs"])]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        worst = 0.0
        for r, want in zip(reqs, fx["runs"]):
            if r.output != want["tokens"]:
                raise SystemExit(f"fixture {fx['arch']}: greedy tokens "
                                 f"{r.output} != the JAX package's "
                                 f"{want['tokens']}")
            with torch.inference_mode():
                logits, _ = api.prefill_fn(params, prefill_batch(
                    cfg, torch.tensor([r.prompt], device="cuda")),
                    cache_len=fx["prompt_len"])
            w = torch.tensor(want["logits"], dtype=torch.float64)
            err = rel_err(logits[0].cpu(), w)
            worst = max(worst, err)
            if not np.isfinite(logits.cpu().numpy()).all() or err > 1e-4:
                raise SystemExit(f"fixture {fx['arch']}: prefill logits "
                                 f"differ from the JAX package's by "
                                 f"{err:.3e} of their largest magnitude")
        print(f"  fixture {fx['arch']}: tokens equal, logits within "
              f"{worst:.2e}", flush=True)
        out.append(dict(arch=fx["arch"], max_rel_err=worst))
    return out


#: the full-width serving runs: (arch, its recurrence kernel or None, text
#: tokens per prompt, max_seq).  internvl2-2b's prompts also carry its 256
#: patch positions (384 tokens).
SERVED = (("rwkv6-7b", "wkv6", 128, 256), ("zamba2-7b", "ssd", 128, 256),
          ("qwen3-0.6b", None, 128, 256),
          ("granite-moe-1b-a400m", None, 128, 256),
          ("internvl2-2b", None, 128, 512),
          ("seamless-m4t-large-v2", None, 128, 256))
KERNEL_NAMES = {"wkv6": "wkv6_kernel", "ssd": "ssd_kernel",
                "flash_attention": "flash_attention_"}


def prompt_tokens(cfg, prompt_len: int, seed: int):
    """One prompt on the card as ``launch.serve.run`` builds them: a vlm's
    n_patches placeholders (0), then ``prompt_len`` seeded tokens."""
    import numpy as np
    import torch
    P = cfg.n_patches if cfg.family == "vlm" else 0
    toks = [0] * P + np.random.default_rng(seed).integers(
        1, 200, size=prompt_len).tolist()
    return torch.tensor([toks], device="cuda")


def attention_calls(cfg) -> int:
    """K4's launches in one prefill: once per attention layer; zamba2 once
    per shared-attention application; an encoder-decoder once per encoder
    layer and twice per decoder layer (self and cross)."""
    from repro_torch.models import zamba2
    if cfg.family == "hybrid":
        return zamba2.n_attn_applications(cfg)
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def expected_launches(cfg, kernel, st: dict) -> dict:
    """Each kernel's launches in one serving run: a recurrence kernel once
    per layer per prefill and decode step; K4 ``attention_calls`` times
    per prefill, never in a decode step; K1 never."""
    calls = st["prefills"] + st["decode_steps"]
    want = dict.fromkeys(read_counts(), 0)
    if kernel:
        want[kernel] = cfg.n_layers * calls
    if cfg.family == "hybrid" or kernel is None:
        want["flash_attention"] = attention_calls(cfg) * st["prefills"]
    return want


def profile_serve(api, params, prompt, max_seq: int) -> dict:
    """One prefill of ``prompt`` and one decode step of the full-width
    model under ``torch.profiler``: wall seconds of each, the device's
    busy seconds (the sum of the kernels' device times; one stream, so
    they do not overlap), its idle share, the port's kernels' seconds and
    the six kernels that took the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import prefill_batch
    torch.cuda.synchronize()
    with torch.inference_mode(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, state = api.prefill_fn(params, prefill_batch(api.cfg, prompt),
                                       cache_len=max_seq)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        api.decode_fn(params, state, {"tokens": logits.argmax(
            -1, keepdim=True), "cur_index": prompt.shape[1]})
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    dev = [(ev.key, getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0)) / 1e6)
           for ev in prof.key_averages()
           if getattr(ev, "device_type", None) == DeviceType.CUDA]
    busy = sum(t for _, t in dev)
    if busy <= 0:
        return dict(wall_s=t2 - t0, device_busy_s="not measured")
    kern = {name: sum(t for key, t in dev if fn in key)
            for name, fn in KERNEL_NAMES.items()}
    return dict(prefill_wall_s=t1 - t0, decode_wall_s=t2 - t1,
                wall_s=t2 - t0, device_busy_s=busy,
                device_idle_share=max(0.0, 1.0 - busy / (t2 - t0)),
                kernel_s={k: t for k, t in kern.items() if t > 0},
                top=sorted(dev, key=lambda kt: -kt[1])[:6])


#: frames of the direct encoder-decoder prefill, beside ``prompt_len``
#: tokens: the cross-attention runs T != S inside the model
CROSS_FRAMES = 384


def encdec_cross_check(api, params, prompt_len: int) -> dict:
    """One ``prefill_fn`` call of the full-width encoder-decoder with
    ``CROSS_FRAMES`` seeded standard-normal frames and ``prompt_len``
    tokens (the engine always gives as many frames as tokens): every K4
    call (encoder T = S = 384, decoder causal T = S = 128, cross T = 128
    over S = 384) held to ``attention_ref`` within SERVE_TOL, finite
    logits, K4 launched ``attention_calls`` times, and every block held to
    a float32 run of it: the kernels' distance to it at most SERVE_TOL
    beyond the plain bf16 path's.  (On such frames the random-init
    encoder's softmax saturates, so its bf16 blocks are ~1e-1 from float32
    on either path, and the two bf16 paths ~1e-2 apart: a rounding flip of
    an attention output moves a block by more than 2^-6 of its largest
    value, where the engine's zero frames do not.)"""
    import torch
    from repro_torch.models import encdec
    cfg = api.cfg
    g = torch.Generator(device="cuda").manual_seed(3)
    batch = dict(tokens=prompt_tokens(cfg, prompt_len, seed=3),
                 frame_embeds=torch.randn((1, CROSS_FRAMES, cfg.d_model),
                                          generator=g, device="cuda"))
    fa = kernel_wrappers()["flash_attention"]
    n0 = fa.launches
    with torch.inference_mode(), attention_compare() as att, \
            block_compare(encdec, False, against_f32=True) as cmp:
        logits, state = api.prefill_fn(params, batch, cache_len=2 * prompt_len)
    torch.cuda.synchronize()
    launches = fa.launches - n0     # the plain runs launch nothing
    want = attention_calls(cfg)
    if (not torch.isfinite(logits).all() or launches != want or
            att.calls != want or att.worst > SERVE_TOL or
            cmp.blocks != cfg.n_enc_layers + cfg.n_layers or
            cmp.worst_excess > SERVE_TOL or
            tuple(state["xk"].shape[2:4]) != (CROSS_FRAMES, cfg.n_kv_heads)):
        raise SystemExit(
            f"encdec prefill over {CROSS_FRAMES} frames: {launches} K4 "
            f"launches and {att.calls} calls (expected {want}) within "
            f"{att.worst:.3e}, {cmp.blocks} blocks: kernels "
            f"{cmp.worst_k_f32:.3e} and plain {cmp.worst_p_f32:.3e} from "
            f"float32 (excess {cmp.worst_excess:.3e} > {SERVE_TOL:.3e}?), "
            f"cross cache {tuple(state['xk'].shape)}")
    out = dict(frames=CROSS_FRAMES, tokens=prompt_len, k4_launches=launches,
               attention_rel_err=att.worst, block_h_rel_err=cmp.worst_h,
               block_kernel_vs_f32=cmp.worst_k_f32,
               block_plain_vs_f32=cmp.worst_p_f32,
               block_excess_over_plain=cmp.worst_excess)
    print(f"  encdec prefill, {CROSS_FRAMES} frames x {prompt_len} tokens: "
          f"{json.dumps(out)}", flush=True)
    return out


def serve_full_width(name: str, kernel, prompt_len: int, max_seq: int,
                     card: str) -> dict:
    """``launch.serve.run`` at the full config of ``name`` (bf16 compute,
    float32 masters from seed 0): 4 slots, 8 requests of ``prompt_len``
    text tokens (a vlm's after its patch positions), 16 tokens each,
    greedy.  Every logit must be finite and every kernel must have
    launched exactly as ``expected_launches`` says (every count is set to
    0 just before the run and read just after it).  Then one request's
    prefill and one decode step with every block run through the kernels
    and through the plain versions on the same inputs (``block_compare``)
    and every K4 call held to ``attention_ref`` (``attention_compare``):
    the attention outputs and the blocks' outputs within SERVE_TOL, the
    recurrent states within REC_TOL of the recurrences' sequential form
    (their distance to the chunked plain form is reported).  The
    end-to-end prefill logits of the two paths are reported, not held."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve
    from repro_torch.models import (encdec, get_model, mamba2, rwkv6,
                                    transformer)
    from repro_torch.serve import prefill_batch
    cfg = ARCHS[name]
    api = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device="cuda").manual_seed(0),
                      torch.device("cuda"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_counts()
    with finite_watch() as watch:
        res = serve.run(cfg, requests=8, slots=4, max_seq=max_seq,
                        max_tokens=16, temperature=0.0, prompt_len=prompt_len,
                        device="cuda", params=params,
                        emit=lambda s: print("  " + s))
    moved = read_counts()
    st = res["stats"]
    want = expected_launches(cfg, kernel, st)
    if moved != want or st["prefills"] != 8:
        raise SystemExit(f"serve {name}: launches {moved}, expected {want} "
                         f"({cfg.n_layers} layers, {st['prefills']} "
                         f"prefills, {st['decode_steps']} decode steps)")
    if watch.nonfinite or watch.calls != st["prefills"] + st["decode_steps"]:
        raise SystemExit(f"serve {name}: {watch.nonfinite} non-finite "
                         f"logits in {watch.calls} calls")
    if res["requests"] != 8 or res["tokens"] != 8 * 16:
        raise SystemExit(f"serve {name}: {res['requests']} requests, "
                         f"{res['tokens']} tokens")
    # one prefill and one decode step, block by block: kernels vs plain
    module = {"wkv6": rwkv6, "ssd": mamba2}.get(
        kernel, encdec if cfg.family == "encdec" else transformer)
    prompt = prompt_tokens(cfg, prompt_len, seed=1)
    batch = prefill_batch(cfg, prompt)
    with torch.inference_mode():
        with attention_compare() as att, \
                block_compare(module, kernel is not None) as cmp:
            lk, state = api.prefill_fn(params, batch, cache_len=max_seq)
            step, _ = api.decode_fn(params, state, {
                "tokens": lk.argmax(-1, keepdim=True),
                "cur_index": prompt.shape[1]})
        with plain_kernels():
            lp, _ = api.prefill_fn(params, batch, cache_len=max_seq)
    if not (torch.isfinite(lk).all() and torch.isfinite(step).all()):
        raise SystemExit(f"serve {name}: non-finite logits")
    want_att = want["flash_attention"] // st["prefills"]
    # a transformer's or an encoder-decoder's decode step calls no block
    # function: it runs no kernel
    want_blocks = (2 if kernel else 1) * cfg.n_layers + \
        (cfg.n_enc_layers if cfg.family == "encdec" else 0)
    if (att.calls != want_att or att.worst > SERVE_TOL or
            cmp.blocks != want_blocks or cmp.worst_h > SERVE_TOL or
            cmp.worst_state > REC_TOL):
        raise SystemExit(
            f"serve {name}: kernels vs plain versions: {att.calls} "
            f"attention calls (expected {want_att}) within "
            f"{att.worst:.3e}; {cmp.blocks} blocks (expected "
            f"{want_blocks}), hidden state {cmp.worst_h:.3e} (> "
            f"{SERVE_TOL:.3e}?), recurrent state vs the sequential form "
            f"{cmp.worst_state:.3e} (> {REC_TOL}?)")
    err = rel_err(lk, lp)
    cross = (encdec_cross_check(api, params, prompt_len)
             if cfg.family == "encdec" else None)
    prof = profile_serve(api, params, prompt_tokens(cfg, prompt_len, seed=2),
                         max_seq)
    out = dict(
        arch=name, family=cfg.family, params=api.n_params(), init_s=init_s,
        prompt_tokens=int(prompt.shape[1]), max_seq=max_seq,
        prefills=st["prefills"], decode_steps=st["decode_steps"],
        prefill_ms=1e3 * st["prefill_s"] / st["prefills"],
        decode_ms_per_step=1e3 * st["decode_s"] / st["decode_steps"],
        tok_per_s=res["tok_per_s"], seconds=res["seconds"],
        tokens=res["tokens"], launches=moved,
        attention_rel_err=att.worst, attention_calls=att.calls,
        block_h_rel_err=cmp.worst_h,
        block_state_rel_err=cmp.worst_state,
        block_state_rel_err_vs_chunked=cmp.worst_state_chunked,
        block_state_chunked_vs_sequential=cmp.chunked_vs_seq,
        logits_rel_err_vs_plain=err, profile=prof, cross_t_ne_s=cross,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, card=card)
    print(f"  serve {name}: prefill {out['prefill_ms']:.2f} ms/request, "
          f"decode {out['decode_ms_per_step']:.2f} ms/step, "
          f"{out['tok_per_s']:.1f} tok/s; kernels vs plain: attention "
          f"{att.worst:.2e} ({att.calls} calls), blocks {cmp.worst_h:.2e} "
          f"(state vs sequential {cmp.worst_state:.2e}, vs chunked "
          f"{cmp.worst_state_chunked:.2e}; chunked vs sequential "
          f"{cmp.chunked_vs_seq:.2e}), end-to-end logits {err:.2e}; "
          f"peak {out['peak_gib']:.1f} GiB ({card})", flush=True)
    del params
    torch.cuda.empty_cache()
    return out

# -------------------------------------------------------------- train phase

#: phase "train": the full-width run (the launcher's defaults but the
#: steps), its checkpoint cadence and the step whose first try fails: a
#: save before the loop, one in the background after step 5, the one at
#: the end (every 4 steps saved a second background one at step 8, beside
#: the end's; PERF.md §4)
TRAIN_ARCH, TRAIN_STEPS, TRAIN_SAVE_EVERY, TRAIN_FAIL_AT = (
    "qwen3-0.6b", 8, 5, 6)
TRAIN_BATCH, TRAIN_SEQ = 8, 128
#: decode steps after the trained weights' prefill
TRAIN_DECODE = 3


def train_fixture(expected: dict) -> dict:
    """(a) The runs of ``configs/train_expected.json`` through the port's
    train step on the card (TF32 off): every loss, gradient norm, learning
    rate and parameter slice within the fixture's tolerance of the JAX
    package's (``tools/train_expected.py``: ``TOL``; the MoE run's
    gradient norms after its first step within ``DRIFT_TOL``)."""
    import torch
    import train_expected as TE      # as the fixture was written
    print(f"  TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("phase train: TF32 is on")
    out = {}
    for arch in TE.ARCHS:
        for mb in TE.MICROBATCHES:
            name = TE.run_name(arch, mb)
            t0 = time.perf_counter()
            got = TE.port_run(arch, mb, "cuda")
            err = TE.compare(got, expected["runs"][name])
            bad = TE.over_tolerance(arch, err)
            out[name] = dict(err, seconds=time.perf_counter() - t0)
            print(f"  train fixture {name}: {json.dumps(out[name])}",
                  flush=True)
            if bad:
                raise SystemExit(f"train fixture {name}: {bad}")
    return out


class timed_checkpoints:
    """Within the block every ``train.checkpoint.save`` and ``restore``
    (sync saves, the async writer's saves, restores) is timed: seconds and
    bytes of each."""

    def __enter__(self):
        from repro_torch.train import checkpoint as ckpt
        self.saved = ckpt.save, ckpt.restore
        self.saves, self.restores = [], []
        lock = threading.Lock()

        def size(path):
            return sum(f.stat().st_size for f in Path(path).iterdir())

        def save(tree, directory, step, **kw):
            t0 = time.perf_counter()
            final = self.saved[0](tree, directory, step, **kw)
            with lock:
                self.saves.append(dict(step=step, s=time.perf_counter() - t0,
                                       gb=size(final) / 1e9))
            return final

        def restore(template, directory, step=None, **kw):
            import torch
            t0 = time.perf_counter()
            out = self.saved[1](template, directory, step, **kw)
            torch.cuda.synchronize()
            path = Path(directory) / f"step_{out[1]['step']:08d}"
            self.restores.append(dict(step=out[1]["step"],
                                      s=time.perf_counter() - t0,
                                      gb=size(path) / 1e9))
            return out
        ckpt.save, ckpt.restore = save, restore
        return self

    def __exit__(self, *exc):
        from repro_torch.train import checkpoint as ckpt
        ckpt.save, ckpt.restore = self.saved
        return False


def profile_train_step(api, tc, state, batch) -> dict:
    """One more train step under ``torch.profiler``: its wall seconds,
    the device's busy seconds (the kernels' device times; one stream) and
    idle share; then the AdamW update alone on that step's gradients,
    profiled the same way: its busy seconds and share of the step's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import train_loop
    from repro_torch.train.optimizer import adamw_update
    step = train_loop.make_train_step(api, tc)
    stash = {}
    orig = train_loop.adamw_update

    def keep(params, grads, opt, tc_):
        stash["args"] = (params, grads, opt, tc_)
        return orig(params, grads, opt, tc_)

    def busy(fn) -> tuple:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = sum(getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0.0)) / 1e6
                  for ev in prof.key_averages()
                  if getattr(ev, "device_type", None) == DeviceType.CUDA)
        return wall, dev

    train_loop.adamw_update = keep
    try:
        wall, dev = busy(lambda: step(state["params"], state["opt"], batch))
    finally:
        train_loop.adamw_update = orig
    opt_wall, opt_dev = busy(lambda: adamw_update(*stash.pop("args")))
    if dev <= 0:
        return dict(wall_s=wall, device_busy_s="not measured")
    return dict(wall_s=wall, device_busy_s=dev,
                device_idle_share=max(0.0, 1.0 - dev / wall),
                optimizer_wall_s=opt_wall, optimizer_busy_s=opt_dev,
                optimizer_share_of_busy=opt_dev / dev)


def train_full_width(work: Path, card: str) -> tuple:
    """(b) ``launch.train.run`` at the full config of ``TRAIN_ARCH``
    (float32 masters from seed 0, bf16 compute; the launcher's batch and
    sequence) for ``TRAIN_STEPS`` steps under ``FaultTolerantLoop``:
    ``TRAIN_SAVE_EVERY``, ``keep=1`` and one injected failure at
    ``TRAIN_FAIL_AT``.  The losses and gradient norms finite, the last
    loss below the first, one restart.  Returns (the run's numbers, the
    final state, the checkpoint directory)."""
    import torch
    from repro_torch.configs import ARCHS, TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import train
    from repro_torch.models import get_model
    cfg = ARCHS[TRAIN_ARCH]
    api = get_model(cfg)
    ckpt_gb = 3 * 4 * api.n_params() / 1e9     # params and two moments
    free_gb = shutil.disk_usage(work).free / 1e9
    print(f"  disk: {free_gb:.1f} GB free under {work}; one checkpoint "
          f"{ckpt_gb:.2f} GB", flush=True)
    if free_gb < 2.2 * ckpt_gb:
        raise SystemExit(f"phase train: {free_gb:.1f} GB free, two "
                         f"checkpoints of {ckpt_gb:.2f} GB need more")
    seen = set()

    def fail_once(s: int) -> bool:
        if s == TRAIN_FAIL_AT and s not in seen:
            seen.add(s)
            return True
        return False
    torch.cuda.reset_peak_memory_stats()
    ckdir = work / "ckpt"
    with timed_checkpoints() as tck:
        res = train.run(cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                        seq=TRAIN_SEQ, ckpt_dir=str(ckdir),
                        save_every=TRAIN_SAVE_EVERY, keep=1, device="cuda",
                        inject_failure=fail_once,
                        emit=lambda m: print("  " + m, flush=True))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses, gnorms = res["loss"], res["grad_norm"]
    if (not all(math.isfinite(x) for x in losses + gnorms) or
            losses[-1] >= losses[0] or res["restarts"] != 1 or
            res["step"][-1] != TRAIN_STEPS - 1):
        raise SystemExit(f"train {TRAIN_ARCH}: losses {losses}, grad norms "
                         f"{gnorms}, {res['restarts']} restarts, steps "
                         f"{res['step']}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = sorted(res["seconds"][1:])[len(res["seconds"][1:]) // 2]
    n = res["n_params"]
    tc = TrainConfig(total_steps=TRAIN_STEPS)
    data = SyntheticLMData(vocab_size=cfg.padded_vocab(), seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch(TRAIN_STEPS).items()}
    prof = profile_train_step(api, tc, res["state"], batch)
    out = dict(
        arch=TRAIN_ARCH, params=n, steps=TRAIN_STEPS, tokens_per_step=tokens,
        steps_run=res["step"], loss=losses, grad_norm=gnorms, lr=res["lr"],
        step_s=res["seconds"], step_ms_median=1e3 * step_s,
        tokens_per_s=tokens / step_s,
        tflops_6nt=6 * n * tokens / step_s / 1e12,
        # the profiled step's own idle share; and, derived, the profiled
        # step's busy seconds over the median unprofiled step's wall
        idle_share_profiled_step=prof.get("device_idle_share",
                                          "not measured"),
        idle_share_derived_median_step=(
            max(0.0, 1.0 - prof["device_busy_s"] / step_s)
            if isinstance(prof["device_busy_s"], float) else "not measured"),
        restarts=res["restarts"], stragglers=res["stragglers"],
        loop_s=res["seconds_total"], peak_gib=peak,
        saves=tck.saves, restores=tck.restores, profile=prof, card=card)
    print(f"  train {TRAIN_ARCH} ({n:,} params): step {out['step_ms_median']:.1f}"
          f" ms (median of {len(res['seconds']) - 1}), "
          f"{out['tokens_per_s']:.0f} tokens/s, 6NT "
          f"{out['tflops_6nt']:.1f} TFLOP/s, peak {peak:.1f} GiB, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, {res['restarts']} restart; "
          f"saves {[round(x['s'], 2) for x in tck.saves]} s of "
          f"{tck.saves[0]['gb']:.2f} GB, restores "
          f"{[round(x['s'], 2) for x in tck.restores]} s; idle share "
          f"{out['idle_share_profiled_step']} of the profiled step "
          f"(derived over the median step: "
          f"{out['idle_share_derived_median_step']}); profiled step "
          f"{json.dumps(prof)} ({card})", flush=True)
    return out, res["state"], ckdir


def serve_trained(ckdir: Path, state) -> dict:
    """(c) The last checkpoint's parameters restored onto the card (equal
    to the loop's final state) and served through ``ServeEngine``: one
    request of ``TRAIN_SEQ`` tokens, one prefill and ``TRAIN_DECODE``
    decode steps, K4 launched once per layer in the prefill and never in
    decode; then one prefill and one decode step with every block and
    every K4 call held to the plain path on the same trained weights."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import get_model, transformer
    from repro_torch.serve import Request, ServeEngine, prefill_batch
    from repro_torch.train import checkpoint as ckpt
    cfg = ARCHS[TRAIN_ARCH]
    api = get_model(cfg)
    t0 = time.perf_counter()
    tree, meta = ckpt.restore({"params": api.abstract()}, str(ckdir),
                              device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    params = tree["params"]
    same = all(torch.equal(a, b) for a, b in zip(
        ckpt._flatten(params).values(),
        ckpt._flatten(state["params"]).values()))
    if meta["step"] != TRAIN_STEPS or not same:
        raise SystemExit(f"restored step {meta['step']}, equal to the "
                         f"final state: {same}")
    max_seq = TRAIN_SEQ + TRAIN_DECODE + 1
    reset_counts()
    eng = ServeEngine(api, params, batch_slots=1, max_seq=max_seq)
    eng.submit(Request(prompt=prompt_tokens(cfg, TRAIN_SEQ, 4)[0].tolist(),
                       max_tokens=TRAIN_DECODE + 1))
    (done,) = eng.run_until_done()
    counts = read_counts()
    st = eng.stats
    want = dict.fromkeys(counts, 0)
    want["flash_attention"] = attention_calls(cfg) * st["prefills"]
    if (counts != want or st["prefills"] != 1 or
            st["decode_steps"] != TRAIN_DECODE or
            len(done.output) != TRAIN_DECODE + 1):
        raise SystemExit(f"serving the trained weights: launches {counts}, "
                         f"expected {want}; {st}")
    prompt = prompt_tokens(cfg, TRAIN_SEQ, 5)
    with torch.inference_mode():
        with attention_compare() as att, block_compare(transformer,
                                                      False) as cmp:
            lk, cache = api.prefill_fn(params, prefill_batch(cfg, prompt),
                                       cache_len=max_seq)
            step, _ = api.decode_fn(params, cache, {
                "tokens": lk.argmax(-1, keepdim=True),
                "cur_index": prompt.shape[1]})
    if (not (torch.isfinite(lk).all() and torch.isfinite(step).all()) or
            att.calls != attention_calls(cfg) or att.worst > SERVE_TOL or
            cmp.blocks != cfg.n_layers or cmp.worst_h > SERVE_TOL):
        raise SystemExit(f"trained weights, kernels vs plain: {att.calls} "
                         f"attention calls within {att.worst:.3e}, "
                         f"{cmp.blocks} blocks within {cmp.worst_h:.3e} "
                         f"(> {SERVE_TOL:.3e}?)")
    out = dict(restore_s=restore_s, restore_gb=4 * api.n_params() / 1e9,
               step=meta["step"], tokens=done.output,
               prefill_ms=1e3 * st["prefill_s"],
               decode_ms_per_step=1e3 * st["decode_s"] / st["decode_steps"],
               launches=counts, attention_rel_err=att.worst,
               attention_calls=att.calls, block_h_rel_err=cmp.worst_h,
               blocks=cmp.blocks)
    print(f"  serve trained {TRAIN_ARCH}: {json.dumps(out)}", flush=True)
    return out


def edan_train_step() -> dict:
    """(d) EDAN on the framework's own train step: the reduced
    ``TRAIN_ARCH``'s loss, gradient and AdamW update traced from ``meta``
    inputs (``tracing.trace_train_step``), then ``report`` and a sweep
    grid (13 alphas x m (2, 4, 8) x (0, 8) ALU slots) under ``("cuda",
    "float32")``: W >= D >= 1, 0 <= Lambda <= 1 (``tests/test_system.py``'s
    checks), no replay chunk on the host, K1 launched."""
    import numpy as np
    from repro_torch.core import backend as B
    from repro_torch.core import report, sweep_grid
    from repro_torch.core.plan import ExecPolicy
    from repro_torch.models import tracing
    t0 = time.perf_counter()
    g = tracing.trace_train_step(TRAIN_ARCH)
    trace_s = time.perf_counter() - t0
    B.reset_stats()
    with k1_counts() as k1:
        r = report(g)
        grid = sweep_grid(g, np.linspace(50.0, 300.0, 13), ms=(2, 4, 8),
                          compute_slots=(0, 8),
                          policy=ExecPolicy.resolve(backend="cuda",
                                                    replay_dtype="float32"))
    if not (r.W >= r.D >= 1 and 0 <= r.Lam <= 1 and r.parallelism >= 1.0 and
            np.isfinite(grid).all() and k1.grids > 0 and
            B.stats["cuda_chunks"] > 0 and B.stats["cpu_chunks"] == 0):
        raise SystemExit(f"EDAN on the train step: W {r.W}, D {r.D}, Lambda "
                         f"{r.Lam}, parallelism {r.parallelism}, K1 grids "
                         f"{k1.grids}, replays {dict(B.stats)}")
    out = dict(vertices=int(g.n_vertices), levels=int(g._level_csr().n_levels),
               trace_s=trace_s, W=r.W, D=r.D, lam=r.lam, Lam=r.Lam,
               parallelism=r.parallelism, replay=B.stats.snapshot(),
               **k1.row())
    print(f"  EDAN on the train step: {json.dumps(out)}", flush=True)
    return out


def run_train(expected: dict, card: str) -> dict:
    """Phase "train": (a) ``train_fixture``, (b) ``train_full_width``,
    both launching none of K2-K4 (every count 0 from before (a) to after
    (b)); (c) ``serve_trained``; (d) ``edan_train_step``."""
    import torch
    reset_counts()
    out = dict(fixture=train_fixture(expected))
    work = scratch_dir("train")
    try:
        out["full"], state, ckdir = train_full_width(work, card)
        counts = read_counts()
        if any(counts.values()):
            raise SystemExit(f"training launched kernels: {counts}")
        out["serve"] = serve_trained(ckdir, state)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del state
    torch.cuda.empty_cache()
    out["edan"] = edan_train_step()
    return out


# ------------------------------------------------------------- dryrun phase

#: the dry-run's estimated peak over the measured one, either remat mode
DRYRUN_PEAK_RATIO = (0.9, 1.1)
#: the temp bytes replayed from a fixture cell's text over XLA's
DRYRUN_TEMP_RATIO = (0.8, 1.25)
#: (batch, seq) of (b): phase "train"'s, where the end of AdamW sets the
#: peak, and one where the activations do
DRYRUN_HOST_SHAPES = ((TRAIN_BATCH, TRAIN_SEQ), (8, 1024))
DRYRUN_EQUAL = ("hlo_flops_per_device", "hlo_bytes_per_device",
                "collectives", "per_axis_lambda", "model_flops_global",
                "model_flops_per_device", "useful_flops_ratio")
DRYRUN_MEMORY = ("argument_size_in_bytes", "alias_size_in_bytes",
                 "output_size_in_bytes")


def dryrun_cells(expected: dict) -> dict:
    """(a) Each fixture cell through the port's ``run_cell`` (no
    per-device step): every HLO-derived value and the model FLOPs equal
    to the JAX package's, the memory bytes exact, K1 launched for the
    per-axis depths of every cell with collectives."""
    from repro_torch.launch import dryrun
    out = {}
    for name, e in sorted(expected["cells"].items()):
        want = e["artifact"]
        with k1_counts() as k1:
            got = dryrun.run_cell(e["arch"], e["shape"], e["mesh"],
                                  step=False)
        if "skipped" in want:
            if got != want:
                raise SystemExit(f"dry-run {name}: {got}, not {want}")
            out[name] = dict(skipped=True, seconds=k1.seconds)
            print(f"  dryrun {name}: skipped, {k1.seconds:.2f} s",
                  flush=True)
            continue
        for key in DRYRUN_EQUAL:
            if jsonable(got[key]) != want[key]:
                raise SystemExit(f"dry-run {name}: {key} {got[key]} is not "
                                 f"the JAX package's {want[key]}")
        for key in DRYRUN_MEMORY:
            if got["memory_analysis"][key] != want["memory_analysis"][key]:
                raise SystemExit(f"dry-run {name}: {key} "
                                 f"{got['memory_analysis'][key]} is not the "
                                 f"JAX package's "
                                 f"{want['memory_analysis'][key]}")
        if got["collectives"]["total"]["count"] > 0 and k1.grids <= 0:
            raise SystemExit(f"dry-run {name}: K1 never launched")
        temp = got["memory_analysis"]["temp_size_in_bytes"]
        ratio = temp / want["memory_analysis"]["temp_size_in_bytes"]
        lo, hi = DRYRUN_TEMP_RATIO
        if not lo <= ratio <= hi or got["fits_hbm"] != want["fits_hbm"]:
            raise SystemExit(f"dry-run {name}: temp {temp} is {ratio:.4f} "
                             f"of XLA's (bound {DRYRUN_TEMP_RATIO}), fits "
                             f"{got['fits_hbm']} against "
                             f"{want['fits_hbm']}")
        out[name] = dict(k1.row(), collectives=got["collectives"]["total"],
                         roofline=got["roofline"], temp_bytes=temp,
                         temp_ratio=ratio,
                         hbm_per_device_bytes=got["hbm_per_device_bytes"],
                         fits_hbm=got["fits_hbm"])
        print(f"  dryrun {name}: {json.dumps(out[name])}", flush=True)
    return out


def measured_step_peak(api, batch, reps: int = 3) -> dict:
    """One warm-up step, then ``torch.cuda.max_memory_allocated()`` over
    one real train step of ``api`` on the card (float32 masters from seed
    0, the launcher's ``TrainConfig``), less what was allocated before it
    other than the step's own inputs; then the median of ``reps`` timed
    steps."""
    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.models.module import tree_leaves
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_loop import make_train_step
    step = make_train_step(api, TrainConfig())
    params = api.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt = adamw_init(params)
    inputs = sum(x.untyped_storage().nbytes() for x in
                 tree_leaves(params) + tree_leaves(opt.mu) +
                 tree_leaves(opt.nu) + [opt.step] + list(batch.values()))
    out = step(params, opt, batch)                  # warm-up
    float(out[2]["loss"])
    del out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step(params, opt, batch)
    float(out[2]["loss"])
    peak = torch.cuda.max_memory_allocated()
    del out
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(params, opt, batch)
        float(out[2]["loss"])
        ms.append(1e3 * (time.perf_counter() - t0))
        del out
    del params, opt
    torch.cuda.empty_cache()
    return dict(peak_bytes=peak - (base - inputs), raw_peak_bytes=peak,
                allocated_before=base, input_bytes=inputs,
                step_ms=sorted(ms)[len(ms) // 2], step_ms_all=ms)


def dryrun_host(card: str) -> dict:
    """(b) ``TRAIN_ARCH`` on the card's 1x1 mesh at each of
    ``DRYRUN_HOST_SHAPES``: the dry-run's estimate (argument + temp)
    against the measured peak of one real step, for ``remat="block"``
    and ``"none"``, each held within ``DRYRUN_PEAK_RATIO``; at the shape
    where the activations set the peak, remat "block"'s estimate must be
    below "none"'s."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import dryrun
    from repro_torch.models import get_model
    base = ARCHS[TRAIN_ARCH]
    n = get_model(base).n_params()
    out = {}
    for (b, t), reps in zip(DRYRUN_HOST_SHAPES, (3, 1)):
        shape = ShapeConfig("train_host", t, b, "train")
        data = SyntheticLMData(vocab_size=base.padded_vocab(), seq_len=t,
                               global_batch=b, seed=0)
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch(0).items()}
        rows = {}
        for mode in ("block", "none"):
            t0 = time.perf_counter()
            art = dryrun.run_cell(TRAIN_ARCH, shape, "host",
                                  overrides={"remat": mode})
            est_s = time.perf_counter() - t0
            mem = art["memory_analysis"]
            est = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
            meas = measured_step_peak(
                get_model(dataclasses.replace(base, remat=mode)), batch,
                reps=reps)
            ratio = est / meas["peak_bytes"]
            roof = art["roofline"]
            row = dict(estimated_peak_bytes=est, ratio=ratio,
                       argument_bytes=mem["argument_size_in_bytes"],
                       temp_bytes=mem["temp_size_in_bytes"],
                       flop_counter_flops=art["cost_analysis"]["flops"],
                       six_n_tokens=6.0 * n * b * t,
                       bytes_accessed=art["cost_analysis"]["bytes accessed"],
                       roofline_compute_ms=1e3 * roof["compute_s"],
                       roofline_memory_ms=1e3 * roof["memory_s"],
                       estimate_s=est_s, **meas)
            rows[mode] = row
            print(f"  dryrun host {b}x{t} remat={mode}: estimated peak "
                  f"{est / 2**30:.3f} GiB, measured "
                  f"{meas['peak_bytes'] / 2**30:.3f} GiB (ratio "
                  f"{ratio:.4f}); FlopCounterMode "
                  f"{row['flop_counter_flops']:.4g} FLOPs, 6NT "
                  f"{row['six_n_tokens']:.4g}; step {meas['step_ms']:.1f} "
                  f"ms, roofline compute {row['roofline_compute_ms']:.2f} "
                  f"ms, memory {row['roofline_memory_ms']:.2f} ms ({card}); "
                  f"{json.dumps(row)}", flush=True)
            lo, hi = DRYRUN_PEAK_RATIO
            if not lo <= ratio <= hi:
                raise SystemExit(f"dry-run {b}x{t} remat={mode}: the "
                                 f"estimated peak is {ratio:.4f} of the "
                                 f"measured one, outside "
                                 f"{DRYRUN_PEAK_RATIO}")
        out[f"{b}x{t}"] = rows
        del batch
        torch.cuda.empty_cache()
    b, t = DRYRUN_HOST_SHAPES[1]
    big = out[f"{b}x{t}"]
    if not big["block"]["estimated_peak_bytes"] < \
            big["none"]["estimated_peak_bytes"]:
        raise SystemExit(f"dry-run {b}x{t}: remat \"block\" estimates "
                         f"{big['block']['estimated_peak_bytes']} bytes, "
                         f"not below \"none\"'s "
                         f"{big['none']['estimated_peak_bytes']}")
    return out


# ---------------------------------------------------------------- moe phase

#: the multi-rank outputs and gradients against one rank's, float32
MOE_TOL = 1e-4


def moe_equivalence(out_dir: str) -> dict:
    """(a) The CPU tests' 8-rank case on the card (``launch.moe_parallel
    --case equivalence``), held to the single-rank path."""
    import numpy as np
    from repro_torch.launch import moe_parallel as mp
    t0 = time.perf_counter()
    rcs = mp.launch("equivalence", out_dir, device="cuda", timeout=300)
    if rcs != [0] * 8:
        raise SystemExit(f"moe equivalence: ranks exited {rcs}")

    def key(tag, what):
        return f"y_{tag}" if what == "y" else f"g_{tag}_{what}"

    whats = ("y", "x") + mp.WEIGHTS
    worst = {}
    for r in range(8):
        res = np.load(os.path.join(out_dir, f"rank{r}.npz"))
        if str(res["device"]) != "cuda":
            raise SystemExit(f"moe equivalence: rank {r} ran on "
                             f"{res['device']}")
        for what in whats:
            one = res[key("single", what)]
            for tag, _ in mp.MODES:
                err = float(np.abs(res[key(tag, what)] - one).max())
                worst[tag] = max(worst.get(tag, 0.0), err)
            if not np.array_equal(res[key("groupless", what)], one):
                raise SystemExit(f"moe equivalence: rank {r}'s {what} "
                                 f"without groups is not the single-rank "
                                 f"path's")
        if int(res["collectives_without_groups"]):
            raise SystemExit("moe equivalence: a mesh without groups ran "
                             "collectives")
    bad = {t: e for t, e in worst.items() if e > MOE_TOL}
    if bad:
        raise SystemExit(f"moe equivalence: {bad} exceed {MOE_TOL} against "
                         f"one rank")
    counts = json.loads(str(np.load(os.path.join(out_dir, "rank0.npz"))[
        "counts"]))
    return dict(worst_abs_err=worst, collectives_rank0=counts,
                seconds=time.perf_counter() - t0)


def moe_prefill(out_dir: str, card: str) -> dict:
    """(b) granite-moe-1b-a400m at full width on 4 ranks sharing the card
    (``launch.moe_parallel --case prefill``); each rank holds its blocks
    to one rank's within ``moe_parallel.PREFILL_TOL`` (= ``SERVE_TOL``)."""
    from repro_torch.launch import moe_parallel as mp
    assert mp.PREFILL_TOL == SERVE_TOL
    t0 = time.perf_counter()
    rcs = mp.launch("prefill", out_dir, device="cuda", timeout=400)
    if rcs != [0] * 4:
        raise SystemExit(f"moe prefill: ranks exited {rcs}")
    ranks = [json.loads(Path(out_dir, f"prefill_rank{r}.json").read_text())
             for r in range(4)]
    out = dict(config=ranks[0]["config"], mesh=ranks[0]["mesh"],
               seconds=None, card=card)
    for tag in ("single",) + tuple(t for t, _ in mp.MODES):
        rows = [r[tag] for r in ranks]
        row = dict(ms_per_moe_layer=[x["ms_per_moe_layer"] for x in rows],
                   k4_launches=[x["k4_launches"] for x in rows],
                   peak_bytes=[x["peak_bytes"] for x in rows],
                   collectives_per_layer=rows[0]["collectives_per_layer"])
        if tag != "single":
            row.update(
                worst_block_rel_err=max(x["worst_block_rel_err"]
                                        for x in rows),
                worst_moe_output_rel_err=max(x["worst_moe_output_rel_err"]
                                             for x in rows),
                blocks_checked=[x["blocks_checked"] for x in rows],
                logits_rel_err=rows[0]["logits_rel_err"])
            if any(x["k4_launches"] <= 0 for x in rows):
                raise SystemExit(f"moe prefill {tag}: a rank never "
                                 f"launched K4")
        if tag == "ep":
            row["dropped_pairs_own_capacity"] = rows[0][
                "dropped_pairs_own_capacity"]
        out[tag] = row
        print(f"  moe prefill {tag} (4 ranks contending for one card; says "
              f"nothing of four cards; {card}): {json.dumps(row)}",
              flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def run_moe(card: str) -> dict:
    """Phase "moe": (a) ``moe_equivalence``, (b) ``moe_prefill``."""
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="moe-", dir=ROOT / "build") as d:
        eq = moe_equivalence(os.path.join(d, "eq"))
        print(f"  moe equivalence (8 ranks on one card): {json.dumps(eq)}",
              flush=True)
        pf = moe_prefill(os.path.join(d, "prefill"), card)
    print("  host-staged collectives: none (gloo takes the ranks' CUDA "
          "tensors itself)", flush=True)
    return dict(equivalence=eq, prefill=pf,
                seconds=time.perf_counter() - t0)


def run_dryrun(expected: dict, card: str) -> dict:
    """Phase "dryrun": (a) ``dryrun_cells``, (b) ``dryrun_host``."""
    t0 = time.perf_counter()
    out = dict(cells=dryrun_cells(expected))
    out["cells_s"] = time.perf_counter() - t0
    out["host"] = dryrun_host(card)
    out["seconds"] = time.perf_counter() - t0
    return out

# -------------------------------------------------------------- shard phase

#: phase "shard" (b): step 1 of each full-width run on 4 ranks against
#: one rank's on the same batch, relative.  The launcher's run (bf16
#: compute): the loss within a quarter of a bf16 unit in the last place
#: (2^-9 of the value; the ranks keep the row-parallel partial sums in
#: float32 where one rank rounds its products to bf16, and sum the token
#: losses in another order).  Step 1's gradient computed in float32: the
#: norm of every leaf, and of all of them, within ``SERVE_TOL`` (2^-6),
#: the tolerance of a bf16 block against the plain path (PERF.md §6).  The
#: bf16 run's gradient norm within ``SHARD_GNORM_TOL`` too, but for
#: ``SHARD_GNORM_BF16_TOL``'s: rwkv6-7b's norm is its bonus ``u``'s (6.6e8
#: at the seeded init, every other leaf's ~20), a sum that cancels, which
#: bf16 rounding moves by 16-30% against float32; the ranks read 0.164
#: from one rank on the card (PERF.md §6)
SHARD_LOSS_TOL = 2.0 ** -9
SHARD_GNORM_TOL = SERVE_TOL
SHARD_GNORM_BF16_TOL = {"rwkv6-7b": 0.25}
#: every rank's peak against the single-rank step's
SHARD_PEAK_SHARE = 0.5
#: (b)'s runs (``launch.sharded.FULL``, which cuts their depth): the
#: kernel each checkpoint is served through in (c)
SHARD_KERNELS = {"rwkv6-7b": "wkv6", "qwen3-0.6b": "flash_attention"}


def shard_fixture(out_dir: str) -> dict:
    """(a) The CPU tests' 8-rank case on the card (``launch.sharded --case
    fixture``; TF32 off in every rank): every case of
    ``configs/shard_expected.json`` within ``tools/shard_expected.py``'s
    tolerances of the reference's shards, on the tensor-parallel path."""
    import shard_expected as SE
    from repro_torch.launch import sharded as S
    t0 = time.perf_counter()
    rcs = S.launch("fixture", out_dir, device="cuda", timeout=300)
    if rcs != [0] * 8:
        raise SystemExit(f"shard fixture: ranks exited {rcs}")
    ranks = [json.loads(Path(out_dir, f"fixture_rank{r}.json").read_text())
             for r in range(8)]
    expected = json.loads((SRC / "repro_torch" / "configs" /
                           "shard_expected.json").read_text())["cases"]

    def gathered(name):
        r0 = ranks[0]["runs"][name]
        pos = [f"d{r['coords']['data']}m{r['coords']['model']}"
               for r in ranks]
        return dict(loss=r0["loss"], grad_norm=r0["grad_norm"], lr=r0["lr"],
                    **{k: {p: r["runs"][name][k] for p, r in zip(pos, ranks)}
                       for k in ("shards", "first_mu")})
    out = {}
    for arch, size, mb in S.CASES:
        name = S.case_name(arch, size, mb)
        err = SE.compare(gathered(name), expected[name])
        bad = SE.over_tolerance(arch, err)
        out[name] = dict(err, path=ranks[0]["runs"][name]["path"],
                         collectives_rank0=ranks[0]["runs"][name][
                             "collectives"])
        print(f"  shard fixture {name}: {json.dumps(out[name])}",
              flush=True)
        if (bad or out[name]["path"] != "tp" or
                any(r["device"] != "cuda" for r in ranks)):
            raise SystemExit(f"shard fixture {name}: {bad}, path "
                             f"{out[name]['path']}")
    out["seconds"] = time.perf_counter() - t0
    return out


def shard_single_step(arch: str, card: str) -> dict:
    """One rank's first step of ``launch.train.run``'s model and batch
    (``arch`` at ``launch.sharded.full_config``'s depth, seed 0, batch 0
    of 8 x 128): loss, gradient norm and ``max_memory_allocated``; then
    the same step's gradient in float32 (``launch.sharded.first_grads``:
    ``f32``, its loss and the norm of each leaf)."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS, TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import sharded as S
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_loop import make_train_step
    cfg = S.full_config(arch, ARCHS)
    steps = S.FULL[arch][1]
    tc = TrainConfig(total_steps=steps, warmup_steps=max(steps // 10, 1))
    data = SyntheticLMData(vocab_size=cfg.padded_vocab(),
                           seq_len=S.FULL_SEQ, global_batch=S.FULL_BATCH,
                           seed=tc.seed)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch(0).items()}
    api = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.init(torch.Generator(device="cuda").manual_seed(tc.seed),
                      torch.device("cuda"))
    opt = adamw_init(params)
    t0 = time.perf_counter()
    params, opt, m = make_train_step(api, tc)(params, opt, batch)
    out = dict(card=card, loss=float(m["loss"]),
               grad_norm=float(m["grad_norm"]),
               step_s=time.perf_counter() - t0,
               peak_bytes=torch.cuda.max_memory_allocated())
    del params, opt, m
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["f32"] = S.first_grads(dataclasses.replace(cfg, dtype="float32"),
                               "cuda")
    out["f32_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return out


def shard_f32_check(ranks: dict, one: dict) -> dict:
    """The ranks' float32 step-1 gradient (``first_grads``) against one
    rank's: relative errors of the loss, of every leaf's norm and of the
    norm of all of them."""
    def total(g):
        return math.sqrt(sum(x * x for x in g.values()))
    rg, og = ranks["grad_norms"], one["grad_norms"]
    if set(rg) != set(og):
        raise SystemExit(f"the ranks' gradient has leaves {sorted(rg)}, one "
                         f"rank's {sorted(og)}")
    leaf = {k: abs(rg[k] - og[k]) / og[k] if og[k] else abs(rg[k])
            for k in og}
    worst = max(leaf, key=leaf.get)
    return dict(loss_rel_err=abs(ranks["loss"] - one["loss"]) / abs(
                    one["loss"]),
                grad_norm_rel_err=abs(total(rg) - total(og)) / total(og),
                grad_norm=total(og), worst_leaf=worst,
                worst_leaf_rel_err=leaf[worst], leaf_rel_err=leaf)


def serve_sharded(arch: str, kernel: str, ckdir: Path, ranks: list) -> dict:
    """(c) The ranks' last checkpoint, the full tree rank 0 assembled,
    restored by this one process: every rank's parameter blocks of it
    equal to that rank's final shards (``launch.sharded.summary``, exact),
    then one 128-token prefill through ``ModelApi.prefill_fn`` (``kernel``
    once per layer, nothing else launched) and one prefill with every
    block (and every K4 call) held to the plain path within
    ``SERVE_TOL``, a recurrent block's state to the sequential form within
    ``REC_TOL``, as phase "serve" holds them."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import sharded as S
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import get_model, rwkv6, transformer
    from repro_torch.serve import prefill_batch
    from repro_torch.sharding.rules import named_sharding
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_loop import (flatten_specs,
                                              shardings_for_train)
    cfg = S.full_config(arch, ARCHS)
    api = get_model(cfg)
    t0 = time.perf_counter()
    tree, meta = ckpt.restore({"params": api.abstract()}, str(ckdir),
                              device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    params = tree["params"]
    mesh = Mesh(ranks[0]["mesh"])
    pspecs, _, _ = shardings_for_train(api, mesh)
    flat_p = ckpt._flatten({"params": params})
    flat_s = flatten_specs({"params": pspecs})
    for r in ranks:
        for key, want in r["params"].items():
            got = S.summary(named_sharding(mesh, flat_s[key]).block(
                flat_p[key], r["coords"]).cpu().numpy())
            if got != want:
                raise SystemExit(f"the served checkpoint's {key} block of "
                                 f"rank {r['rank']} is not its shard")
    if meta["step"] != S.FULL[arch][1]:
        raise SystemExit(f"restored step {meta['step']}")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        first, _ = api.prefill_fn(params, prefill_batch(
            cfg, prompt_tokens(cfg, TRAIN_SEQ, 6)), cache_len=TRAIN_SEQ)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    counts = read_counts()
    recurrent = kernel != "flash_attention"
    want = expected_launches(cfg, kernel if recurrent else None,
                             dict(prefills=1, decode_steps=0))
    if counts != want or not torch.isfinite(first).all():
        raise SystemExit(f"serving the sharded {arch} weights: launches "
                         f"{counts}, expected {want}")
    prompt = prompt_tokens(cfg, TRAIN_SEQ, 7)
    module = rwkv6 if recurrent else transformer
    with torch.inference_mode():
        with attention_compare() as att, block_compare(module,
                                                      recurrent) as cmp:
            lk, _ = api.prefill_fn(params, prefill_batch(cfg, prompt),
                                   cache_len=TRAIN_SEQ + 1)
    if (not torch.isfinite(lk).all() or
            att.calls != want["flash_attention"] or att.worst > SERVE_TOL or
            cmp.blocks != cfg.n_layers or cmp.worst_h > SERVE_TOL or
            cmp.worst_state > REC_TOL):
        raise SystemExit(f"sharded {arch} weights, kernels vs plain: "
                         f"{att.calls} attention calls within "
                         f"{att.worst:.3e}, {cmp.blocks} blocks within "
                         f"{cmp.worst_h:.3e} (> {SERVE_TOL:.3e}?), states "
                         f"within {cmp.worst_state:.3e} (> {REC_TOL}?)")
    out = dict(arch=arch, kernel=kernel, restore_s=restore_s,
               step=meta["step"], token=int(first.argmax(-1)[0]),
               prefill_ms=prefill_ms, launches=counts,
               attention_rel_err=att.worst, attention_calls=att.calls,
               block_h_rel_err=cmp.worst_h, block_state_rel_err=(
                   cmp.worst_state if recurrent else None),
               blocks=cmp.blocks)
    del params, tree
    torch.cuda.empty_cache()
    print(f"  serve the sharded {arch} checkpoint: {json.dumps(out)}",
          flush=True)
    return out


def shard_full_width(work: Path, card: str) -> dict:
    """(b) Each of ``launch.sharded.FULL`` at full width, its depth cut,
    one after the other on the same 4 ranks of a (2, 2) mesh sharing the
    card (``launch.sharded --case full``: step 1's gradient in float32,
    then the launcher's ``run`` under ``ShardedLoop``, batch 8 x 128):
    losses finite, the tensor-parallel path, step 1 within
    ``SHARD_LOSS_TOL`` (losses) and ``SHARD_GNORM_TOL`` (the float32
    gradient's every leaf and whole norm; the bf16 norm as that
    constant's comment says) of one rank's, every rank's peak below
    ``SHARD_PEAK_SHARE`` of one rank's step; then (c)
    ``serve_sharded`` through the run's kernel, each checkpoint removed
    after it."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import sharded as S
    from repro_torch.models import get_model
    ones = {}
    for arch in S.FULL:
        ones[arch] = shard_single_step(arch, card)
        print(f"  {arch}: one rank's step 1: {json.dumps(ones[arch])}",
              flush=True)
    work.mkdir(parents=True, exist_ok=True)
    free_gb = shutil.disk_usage(work).free / 1e9
    ckpt_gb = sum(3 * 4 * get_model(S.full_config(a, ARCHS)).n_params()
                  for a in S.FULL) / 1e9
    if free_gb < 1.2 * ckpt_gb:
        raise SystemExit(f"phase shard: {free_gb:.1f} GB free under {work}, "
                         f"the checkpoints take {ckpt_gb:.1f} GB")
    t0 = time.perf_counter()
    rcs = S.launch("full", str(work), device="cuda", timeout=600)
    ranks_s = time.perf_counter() - t0
    if rcs != [0] * 4:
        raise SystemExit(f"shard full: ranks exited {rcs}")
    out = dict(ranks_s=ranks_s)
    for arch in S.FULL:
        ranks = [json.loads((work / arch / f"full_rank{r}.json").read_text())
                 for r in range(4)]
        r0, one = ranks[0], ones[arch]
        loss_err = abs(r0["loss"][0] - one["loss"]) / abs(one["loss"])
        gn_err = abs(r0["grad_norm"][0] - one["grad_norm"]) / \
            one["grad_norm"]
        gn_tol = SHARD_GNORM_BF16_TOL.get(arch, SHARD_GNORM_TOL)
        f32 = shard_f32_check(r0["first_f32"], one["f32"])
        peaks = [r["peak_bytes"] for r in ranks]
        steps_ms = [1e3 * s for s in r0["seconds"]]
        res = dict(
            arch=arch, n_layers=r0["n_layers"], mesh=r0["mesh"],
            path=r0["path"], params=r0["n_params"], steps=len(r0["loss"]),
            loss=r0["loss"], grad_norm=r0["grad_norm"], lr=r0["lr"],
            loss_rel_err_step1=loss_err, grad_norm_rel_err_step1=gn_err,
            grad_norm_tol_step1=gn_tol, f32_step1=f32,
            one_rank={k: v for k, v in one.items() if k != "f32"},
            step_ms_rank0=steps_ms,
            step_ms_median_rank0=sorted(steps_ms)[len(steps_ms) // 2],
            step_ms_per_rank=[[1e3 * s for s in r["seconds"]]
                              for r in ranks],
            collectives_per_step_rank0=r0["collectives_per_step"],
            checkpoint_collectives_rank0=r0["checkpoint_collectives"],
            peak_bytes=peaks, peak_share_of_one_rank=[
                p / one["peak_bytes"] for p in peaks],
            loop_s_rank0=r0["seconds_total"], card=card)
        print(f"  shard full width {arch} (4 ranks contending for one "
              f"card; says nothing of four cards; {card}): "
              f"{json.dumps(res)}", flush=True)
        if (not all(math.isfinite(x) for r in ranks
                    for x in r["loss"] + r["grad_norm"]) or
                loss_err > SHARD_LOSS_TOL or gn_err > gn_tol or
                f32["loss_rel_err"] > SHARD_LOSS_TOL or
                f32["grad_norm_rel_err"] > SHARD_GNORM_TOL or
                f32["worst_leaf_rel_err"] > SHARD_GNORM_TOL or
                max(peaks) >= SHARD_PEAK_SHARE * one["peak_bytes"] or
                r0["path"] != "tp"):
            raise SystemExit(
                f"shard full width {arch}: losses {r0['loss']}, norms "
                f"{r0['grad_norm']}, step 1 loss {loss_err:.3e} (> "
                f"{SHARD_LOSS_TOL:.1e}?), grad norm {gn_err:.3e} (> "
                f"{gn_tol:.1e}?); float32: loss {f32['loss_rel_err']:.3e}, "
                f"grad norm {f32['grad_norm_rel_err']:.3e}, leaf "
                f"{f32['worst_leaf']} {f32['worst_leaf_rel_err']:.3e} (> "
                f"{SHARD_GNORM_TOL:.1e}?); peaks {peaks} against "
                f"{one['peak_bytes']}, path {r0['path']}")
        res["serve"] = serve_sharded(arch, SHARD_KERNELS[arch],
                                     work / arch / "ckpt", ranks)
        shutil.rmtree(work / arch, ignore_errors=True)
        torch.cuda.empty_cache()
        out[arch] = res
    return out


def run_shard(card: str) -> dict:
    """Phase "shard": (a) ``shard_fixture``, then (b) ``shard_full_width``
    and (c) its ``serve_sharded`` of each of ``launch.sharded.FULL``."""
    t0 = time.perf_counter()
    work = scratch_dir("shard")
    try:
        out = dict(fixture=shard_fixture(str(work / "fixture")))
        out.update(shard_full_width(work / "full", card))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    global HBM_BYTES_PER_S, F32_OPS_PER_S, BF16_OPS_PER_S
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
    sys.path.insert(0, str(ROOT / "tools"))     # the fixture writers
    os.environ["EDAN_TORCH_BACKEND"] = "cuda"
    # phases "persist" and "service" point the schedule cache at their own
    # directories; the others keep it off, so their results and counters
    # depend on nothing a directory holds
    os.environ["EDAN_SCHEDULE_CACHE"] = "off"
    for knob in ("EDAN_X64", "EDAN_REPLAY_DTYPE", "EDAN_REPLAY_MEM_BUDGET",
                 "EDAN_SCHEDULE_CACHE_MIN", "EDAN_SCHEDULE_CACHE_MAX",
                 "EDAN_SCHEDULE_CACHE_MMAP_MIN", "EDAN_LEGACY_BUILD",
                 "EDAN_TRACE_STORE", "EDAN_FAULTS", "EDAN_DEADLINE_S",
                 "EDAN_MAX_RETRIES"):
        os.environ.pop(knob, None)
    import numpy as np  # noqa: F401
    from repro_torch.configs.base import HW
    HBM_BYTES_PER_S, F32_OPS_PER_S, BF16_OPS_PER_S = (
        HW["hbm_bw"], HW["peak_flops_f32"], HW["peak_flops_bf16"])
    from repro_torch.apps import polybench
    from repro_torch.core import backend as B
    from repro_torch.core.plan import ExecPolicy
    from repro_torch.kernels.cuda_build import build_all
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
        kernels = kernel_wrappers()
        build_all(k.lib for k in kernels.values())
        for name, k in kernels.items():
            print(f"  {name}:\n" + (k.build_log.strip() or
                                    "  (library already built)"), flush=True)

    suite_expected = json.loads((SRC / "repro_torch" / "configs" /
                                 "suite_expected.json").read_text())
    with phase("kernel"):
        gemm = polybench.trace_kernel("gemm", 20)
        gplan = replay_plan(gemm, 4, 8)
        n_alpha = len(paper.ANALYSIS.alpha_sweep)
        cases = [(random_dag(s)._level_csr(), 5, s, f"random DAG {s}")
                 for s in range(3)]
        cases += [(replay_plan(random_dag(s), 2, 3).lv, 13, s,
                   f"random DAG {s} replay m=2 cs=3") for s in range(3)]
        layered = layered_dag((5, 600, 3, 2, 7, 400, 1, 300, 4, 4))
        cases += [(layered._level_csr(), 11, 3, "layered DAG"),
                  (replay_plan(layered, 300, 300).lv, 11, 4,
                   "layered DAG replay m=cs=300"),
                  (gemm._level_csr(), 1, 11, "gemm N=20"),
                  (gemm._level_csr(), n_alpha, 11, "gemm N=20"),
                  (gplan.lv, n_alpha, 11, "gemm N=20 replay m=4 cs=8")]
        suite3, uplan, cplan, cuplan, wide, wplan, wcplan = union_plans()
        # the suite grid's column count
        k_suite = len(suite_expected["grid_config"]["alphas"])
        cases += [(uplan.lv, n_alpha, 12,
                   "union gemm+atax+lu N=20 replay (2,0)+(4,8)"),
                  (cplan.lv, n_alpha, 13,
                   "gemm N=20 class-mode replay m=4 cs=8"),
                  (cuplan.lv, n_alpha, 14,
                   "union gemm+atax+lu N=20 class-mode replay"),
                  (wplan.lv, k_suite, 15,
                   f"wide union of {len(wide.members)} PAPER_15 members "
                   f"N=20 replay (8,0)+(8,8)", True),
                  (wcplan.lv, k_suite, 16,
                   f"wide union of {len(wide.members)} PAPER_15 members "
                   f"N=20 class-mode replay (8,0)+(8,8)", True)]
        n_cases, max_err = 0, 0.0
        for case in cases:
            n, err = check_kernel(*case)
            n_cases += n
            max_err = max(max_err, err)
        print(f"  {n_cases} kernel/plain cases bitwise equal", flush=True)
        meas = dict(
            gemm_replay_f32=measure(gplan.lv, n_alpha, torch.float32, False,
                                    True, reps=20, plain_reps=2),
            # float64's plain and library times are not reported
            gemm_replay_f64=measure(gplan.lv, n_alpha, torch.float64, False,
                                    True, reps=20, plain_reps=0))
        for key, m in meas.items():
            print(f"  {key}: {json.dumps(m)}", flush=True)
        union_meas = dict(
            narrow=union_vs_members(suite3, uplan, UNION_PAIRS, n_alpha),
            wide=union_vs_members(wide, wplan, WIDE_PAIRS, k_suite))
        print(f"  union vs members: {json.dumps(union_meas)}", flush=True)
        hpcg_pass = hpcg_dag_pass()
        print(f"  hpcg DAG pass: {json.dumps(hpcg_pass)}", flush=True)
        prof = profile_sweep()
        print(f"  profile: {json.dumps(prof)}", flush=True)
        rec_checks = check_recurrences()
        rec_times = time_recurrences()
        att_checks = check_attention()
        att_times = time_attention()

    expected = json.loads((SRC / "repro_torch" / "configs" /
                           "paper_expected.json").read_text())
    with phase("main"):
        reset_counts()
        B.reset_stats()
        launches = run_main_path(expected, ExecPolicy.resolve(),
                                 paper.FIGURES, "default")
        if B.stats["cuda_chunks"] <= 0 or B.stats["cpu_chunks"] != 0:
            raise SystemExit(f"replay chunks did not run on the card: "
                             f"{dict(B.stats)}")
        if (B.stats["latency_bound_chunks"] != B.stats["chunks"] or
                B.stats["certified_columns"] != 0):
            raise SystemExit(f"the default policy did not run one float64 "
                             f"pass a chunk: {dict(B.stats)}")
        default_stats = B.stats.snapshot()
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
        main_levels = level_step.levels

    with phase("suite"):
        reset_counts()
        suite_res = run_suite(suite_expected)
        suite_launches = read_counts()
        if suite_launches["level_step"] <= 0:
            raise SystemExit("the suite path never launched level_step")
        print(f"  suite: {json.dumps(suite_res)}", flush=True)
        print(f"  suite launches: {suite_launches}", flush=True)

    with phase("fixture"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        fixtures = run_fixtures(json.loads(
            (SRC / "repro_torch" / "configs" / "serve_expected.json")
            .read_text()))

    with phase("serve"):
        served = [serve_full_width(*run, card) for run in SERVED]
        # the serving runs' own launches (not the comparisons after them)
        serve_launches = {k: sum(m["launches"][k] for m in served)
                          for k in ("wkv6", "ssd", "flash_attention")}
        for k, n in serve_launches.items():
            if n <= 0:
                raise SystemExit(f"the serving path never launched {k}")

    service_expected = json.loads((SRC / "repro_torch" / "configs" /
                                   "service_expected.json").read_text())
    with phase("persist"):
        reset_counts()
        persist_res = run_persist(service_expected["persist"])
        persist_launches = read_counts()["level_step"] + sum(
            r["k1"]["launches"] for r in persist_res["gemm"].values())
        if persist_launches <= 0:
            raise SystemExit("the persist path never launched level_step")
        print(f"  persist: {json.dumps(persist_res)}", flush=True)
        print(f"  persist launches: {persist_launches}", flush=True)

    with phase("service"):
        reset_counts()
        service_res = run_service(service_expected["service"])
        service_launches = read_counts()["level_step"]
        if service_launches <= 0:
            raise SystemExit("the service path never launched level_step")
        print(f"  service: {json.dumps(service_res)}", flush=True)
        print(f"  service launches: {service_launches}", flush=True)

    frontend_expected = json.loads((SRC / "repro_torch" / "configs" /
                                    "frontend_expected.json").read_text())
    with phase("frontend"):
        reset_counts()
        frontend_res = run_frontend(frontend_expected)
        frontend_launches = read_counts()["level_step"]
        hlo_grids = sum(r["k1_grids"] for r in frontend_res["hlo"].values())
        if frontend_launches <= 0 or hlo_grids <= 0:
            raise SystemExit(f"the frontend path launched level_step "
                             f"{frontend_launches} times, {hlo_grids} for "
                             f"the HLO fixtures")
        fe_cases, fe_err = frontend_kernel_checks(
            frontend_expected["config"]["twins"])
        n_cases += fe_cases
        max_err = max(max_err, fe_err)
        print(f"  frontend launches: {frontend_launches}", flush=True)

    zoo_expected = json.loads((SRC / "repro_torch" / "configs" /
                               "zoo_expected.json").read_text())
    with phase("zoo"):
        reset_counts()
        t_zoo = time.perf_counter()
        zoo_res, zoo_graphs = run_zoo(zoo_expected)
        zoo_res["seconds"] = time.perf_counter() - t_zoo
        zoo_counts = read_counts()
        launches_zoo = zoo_counts.pop("level_step")
        if launches_zoo <= 0 or any(zoo_counts.values()):
            raise SystemExit(f"the zoo path launched level_step "
                             f"{launches_zoo} times and the model kernels "
                             f"{zoo_counts} (tracing runs none)")
        zk = "seamless-m4t-large-v2:prefill"
        zoo_cases, zoo_err = check_kernel(
            replay_plan(zoo_graphs[zk], 4, 8).lv, 13, 31,
            f"{zk} replay m=4 cs=8")
        n_cases += zoo_cases
        max_err = max(max_err, zoo_err)
        print(f"  zoo launches: {launches_zoo}; K1 vs plain on the {zk} "
              f"replay plan: {zoo_cases} cases bitwise", flush=True)

    train_expected = json.loads((SRC / "repro_torch" / "configs" /
                                 "train_expected.json").read_text())
    with phase("train"):
        t_train = time.perf_counter()
        train_res = run_train(train_expected, card)
        train_res["seconds"] = time.perf_counter() - t_train

    dryrun_expected = json.loads((SRC / "repro_torch" / "configs" /
                                  "dryrun_expected.json").read_text())
    with phase("dryrun"):
        reset_counts()
        dryrun_res = run_dryrun(dryrun_expected, card)
        dryrun_counts = read_counts()
        launches_dryrun = dryrun_counts.pop("level_step")
        if launches_dryrun <= 0 or any(dryrun_counts.values()):
            raise SystemExit(f"the dry-run launched level_step "
                             f"{launches_dryrun} times and the model "
                             f"kernels {dryrun_counts}")

    with phase("moe"):
        moe_res = run_moe(card)

    with phase("shard"):
        shard_res = run_shard(card)

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
            launches_per_call=m["launches_per_call"],
            levels_per_call=m["levels_per_call"],
            us_per_level=m["us_per_level"],
            shape=("gemm N=20 replay plan m=4 cs=8, k=11 float32, R_out, "
                   "one call"),
            levels=main_levels, hpcg_dag_pass=hpcg_pass,
            launches_per_figure=dict(default=launches, float64=launches_x64),
            stats=dict(default=default_stats, dirty_sweep=dirty_stats,
                       float64=B.stats.snapshot()),
            measurements=meas, sweep_profile=prof, kernel_cases=n_cases,
            launches_suite=suite_launches["level_step"],
            launches_persist=persist_launches,
            launches_service=service_launches,
            launches_frontend=frontend_launches,
            launches_zoo=launches_zoo,
            launches_train=train_res["edan"]["k1_grids"],
            launches_dryrun=launches_dryrun,
            plain_ms_union=union_meas["narrow"]["union"]["plain_ms"],
            library_ms_union=union_meas["narrow"]["union"]["library_ms"],
            plain_ms_union_wide=union_meas["wide"]["union"]["plain_ms"],
            library_ms_union_wide=union_meas["wide"]["union"][
                "library_ms"],
            us_per_level_union=union_meas["narrow"]["union"]["us_per_level"],
            us_per_level_union_wide=union_meas["wide"]["union"][
                "us_per_level"],
            union_vs_members=union_meas,
            suite=dict(suite_s=suite_res["suite"]["seconds"],
                       loop_s=suite_res["loop"]["seconds"],
                       grids=suite_res["suite"]["k1_grids"],
                       levels=suite_res["suite"]["k1_levels"],
                       loop_grids=suite_res["loop"]["k1_grids"],
                       loop_levels=suite_res["loop"]["k1_levels"]))
        recs = []
        for name, src, tpu in (
                ("wkv6", "src/repro_torch/csrc/wkv6.cu",
                 "src/repro/kernels/rwkv6_wkv.py:72"),
                ("ssd", "src/repro_torch/csrc/ssd.cu",
                 "src/repro/kernels/mamba2_ssd.py:70")):
            t1, t128, t2048 = (rec_times[name][f"T={T}"]
                               for T in (1, 128, 2048))
            recs.append(dict(
                name=name, route="cuda", source=src, replaces=tpu,
                launches=serve_launches[name],
                max_abs_err=rec_checks[name]["max_abs_err"],
                ms=t128["ms"], plain_ms=t128["plain_ms"],
                bound_ms=t128["bound_ms"], bound_by=t128["bound_by"],
                library_ms=None, shape="prefill, one request, T=128",
                device_us=t128["device_us"],
                ms_t1=t1["ms"], plain_ms_t1=t1["plain_ms"],
                bound_ms_t1=t1["bound_ms"], bound_by_t1=t1["bound_by"],
                device_us_t1=t1["device_us"],
                shape_t1="decode step, 4 slots, T=1",
                ms_t2048=t2048["ms"], device_us_t2048=t2048["device_us"],
                bound_ms_t2048=t2048["bound_ms"],
                shape_t2048="one request, T=2048",
                max_rel_err=rec_checks[name]["max_rel_err"],
                kernel_cases=rec_checks[name]["cases"]))
        recs[0]["launches_shard"] = shard_res["rwkv6-7b"]["serve"][
            "launches"]["wkv6"]
        t = att_times["qwen3-0.6b"]
        recs.append(dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:72",
            launches=serve_launches["flash_attention"],
            launches_per_arch={m["arch"]: m["launches"]["flash_attention"]
                               for m in served},
            launches_train=train_res["serve"]["launches"]["flash_attention"],
            launches_shard=shard_res["qwen3-0.6b"]["serve"]["launches"][
                "flash_attention"],
            max_abs_err=att_checks["max_abs_err"],
            max_rel_err=att_checks["max_rel_err"],
            max_rel_err_round_p=att_checks["max_rel_err_round_p"],
            max_round_p_excess=att_checks["max_round_p_excess"],
            kernel_cases=att_checks["cases"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            device_us=t["device_us"],
            library_device_us=t["library_device_us"],
            shape="qwen3-0.6b prefill, one request, T=128 H=16 KV=8 hd=128 "
                  "bf16 causal",
            timings=att_times))
        print(f"  serve: {json.dumps(served)}", flush=True)
        print(f"  fixtures: {json.dumps(fixtures)}", flush=True)
        print(f"  frontend: {json.dumps(frontend_res)}", flush=True)
        print(f"  zoo: {json.dumps(zoo_res)}", flush=True)
        print(f"  train: {json.dumps(train_res)}", flush=True)
        print(f"  dryrun: {json.dumps(dryrun_res)}", flush=True)
        print(f"  moe: {json.dumps(moe_res)}", flush=True)
        print(f"  shard: {json.dumps(shard_res)}", flush=True)
        print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    # the last three lines: the card, the kernels, the verdict
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [kern] + recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
