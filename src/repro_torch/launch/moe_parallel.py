"""The MoE layer's multi-rank paths (``models/moe.py`` under a
``launch.mesh.RankMesh``) run over ``torch.distributed``: a launcher that
starts the ranks as processes, and the cases they run.

* ``equivalence`` (the reference's ``tests/test_moe_parallel.py`` case):
  reduced granite-moe (d 64, d_ff 32, 8 experts, top-2, capacity factor 8)
  on a (2, 4) mesh of 8 ranks, seeded numpy inputs and weights; for "tp",
  "ep" and "tp" with ``moe_scatter_out``, and "tp" and "ep" at capacity
  factor 1 (where the ranks' blocks drop pairs), the global output, the
  aux loss and the gradient of ``y.sum()`` with respect to the input and
  every weight, and the same on one rank (no mesh) and under a mesh with
  no process group behind it.  Each rank writes ``rank<r>.npz`` to ``--out``.
* ``prefill``: granite-moe-1b-a400m at full width (float32 masters from
  seed 0, bf16 compute) on a (1, 4) mesh; one prefill of 4 x 128 tokens in
  "tp", "tp" with ``moe_scatter_out`` and "ep" at capacity factor 4, where
  no (token, expert) pair can drop, each block (its MoE FFN on the ranks)
  held to the single-rank block on the same input, rank 0's, and the MoE
  outputs' difference reported; the dropped pairs of one rank and
  of "ep" at the config's own capacity factor; milliseconds per MoE layer,
  collectives and bytes per layer, K4 launches and peak memory per rank.
  Each rank writes ``prefill_rank<r>.json`` to ``--out``.  The ranks
  share one card, so their times contend for it and say nothing of four
  cards.
  ``--reduced --device cpu`` rehearses it on the reduced config.

The ranks use ``gloo`` (NCCL refuses two ranks on one GPU), which takes
the CUDA tensors itself (``sharding.collectives``).

Usage:
  python -m repro_torch.launch.moe_parallel --case equivalence --out DIR
      [--device cpu]
  python -m repro_torch.launch.moe_parallel --case prefill --out DIR
      [--reduced --device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from .mesh import close_ranks, init_rank, spawn_ranks

#: the case's world size and model-axis size
WORLDS = {"equivalence": (8, 4), "prefill": (4, 4)}
#: (tag, config overrides) of the multi-rank runs
MODES = (("tp", {"moe_parallelism": "tp"}),
         ("ep", {"moe_parallelism": "ep"}),
         ("tp_scatter", {"moe_parallelism": "tp", "moe_scatter_out": True}))
#: the equivalence case again at capacity factor 1, where the ranks'
#: blocks drop pairs that one rank keeps
DROP_MODES = (("tp_drop", {"moe_parallelism": "tp", "capacity_factor": 1.0}),
              ("ep_drop", {"moe_parallelism": "ep", "capacity_factor": 1.0}))
WEIGHTS = ("router", "wg", "wu", "wd")
#: bf16 blocks against the single-rank block (chip_smoke's SERVE_TOL)
PREFILL_TOL = 2.0 ** -6


def launch(case: str, out: str, device: str = "cuda",
           timeout: float = 600.0, reduced: bool = False) -> list:
    """Run ``case`` on its ranks, one process each; return their exit
    codes.  Every rank still running at ``timeout`` seconds is killed."""
    return spawn_ranks("repro_torch.launch.moe_parallel",
                       ["--case", case, "--out", out, "--device", device] +
                       (["--reduced"] if reduced else []), WORLDS[case][0],
                       timeout)


# ------------------------------------------------------------- equivalence

def equivalence_case():
    """(cfg, x (4, 8, 64), weights) of the case, seeded numpy float32."""
    from ..configs import ARCHS
    cfg = dataclasses.replace(ARCHS["granite-moe-1b-a400m"].reduced(),
                              d_model=64, d_ff=32, n_experts=8, top_k=2,
                              capacity_factor=8.0)
    rng = np.random.default_rng(0)
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    wb = {"router": rng.standard_normal((d, E)) * 0.1,
          "wg": rng.standard_normal((E, d, ff)) * 0.1,
          "wu": rng.standard_normal((E, d, ff)) * 0.1,
          "wd": rng.standard_normal((E, ff, d)) * 0.1}
    x = rng.standard_normal((4, 8, d))
    return (cfg, x.astype(np.float32),
            {k: v.astype(np.float32) for k, v in wb.items()})


def _run_equivalence(mesh, out: str, device: str) -> None:
    import torch
    from ..models import moe
    from ..sharding import collectives as coll
    from ..sharding.rules import sharding_ctx
    from .mesh import Mesh
    cfg, x_np, wb_np = equivalence_case()
    res = {}

    def run(tag, c, ctx_mesh):
        x = torch.from_numpy(x_np).to(device).requires_grad_(True)
        wb = {k: torch.from_numpy(v).to(device).requires_grad_(True)
              for k, v in wb_np.items()}
        with sharding_ctx(ctx_mesh):
            y, aux = moe.moe_ffn(x, wb, c)
            grads = torch.autograd.grad(y.sum(), [x] + [wb[k] for k in
                                                       WEIGHTS])
        res[f"y_{tag}"] = y.detach().cpu().numpy()
        res[f"aux_{tag}"] = np.asarray(float(aux.detach()))
        for name, g in zip(("x",) + WEIGHTS, grads):
            res[f"g_{tag}_{name}"] = g.cpu().numpy()

    coll.reset_counts()
    run("single", cfg, None)
    run("groupless", cfg, Mesh(dict(mesh.shape)))
    res["collectives_without_groups"] = np.asarray(
        sum(c[0] for c in coll.COUNTS.values()))
    for tag, knob in MODES + DROP_MODES:
        run(tag, dataclasses.replace(cfg, **knob), mesh)
    res["coords"] = np.asarray([mesh.coords["data"], mesh.coords["model"]])
    res["counts"] = np.asarray(json.dumps(coll.COUNTS))
    res["device"] = np.asarray(device)
    np.savez(os.path.join(out, f"rank{mesh.rank}.npz"), **res)


# ----------------------------------------------------------------- prefill

def _run_prefill(mesh, out: str, device: str, reduced: bool) -> None:
    import torch
    from ..configs import ARCHS
    from ..kernels import flash_attention as fa
    import torch.distributed as dist
    from ..models import get_model, moe, transformer
    from ..sharding import collectives as coll
    from ..sharding.rules import current_mesh, sharding_ctx
    base = ARCHS["granite-moe-1b-a400m"]
    if reduced:
        base = base.reduced()
    cuda = device == "cuda"
    params = get_model(base).init(
        torch.Generator(device=device).manual_seed(0), device)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, base.vocab_size, (4, 128))).to(device)
    local_moe, local_block = moe.moe_ffn, transformer.block_apply
    report = {"rank": mesh.rank, "mesh": dict(mesh.shape),
              "device": torch.cuda.get_device_name(0) if cuda else "cpu",
              "config": {"n_layers": base.n_layers, "d_model": base.d_model,
                         "n_experts": base.n_experts, "top_k": base.top_k,
                         "dtype": base.dtype, "batch": 4, "seq": 128}}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() /
                     b.float().abs().max().clamp_min(1e-30))

    def drops(x, router, cfg, shards):
        """(token, expert) pairs beyond capacity with the tokens of ``x``
        split into ``shards`` blocks along the sequence."""
        n = 0
        for xs in x.chunk(shards, dim=1):
            xs = xs.reshape(-1, xs.shape[-1])
            probs = torch.softmax(xs.float() @ router.float(), -1)
            idx = torch.sort(probs, dim=-1, descending=True,
                             stable=True)[1][:, :cfg.top_k]
            counts = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
            n += int((counts - moe._capacity(xs.shape[0], cfg))
                     .clamp_min(0).sum())
        return n

    def run(tag, cfg, ctx_mesh):
        stats = {"worst": 0.0, "worst_moe": 0.0, "ms": [], "blocks": 0,
                 "single": 0, "ep": 0, "k4": 0}
        own = dataclasses.replace(cfg, capacity_factor=base.capacity_factor)

        def checked_block(h, wb, c, positions):
            """The block on this rank's mesh and on one rank, on one input:
            rank 0's (each rank computed the replicated layers before it
            itself, and CUDA's ``index_add_`` adds in no fixed order)."""
            if ctx_mesh is None:
                return local_block(h, wb, c, positions)
            h = h.contiguous()
            dist.broadcast(h, src=0)
            with sharding_ctx(None):
                want = local_block(h, wb, c, positions)
            k4 = fa.flash_attention.launches
            got = local_block(h, wb, c, positions)
            stats["k4"] += fa.flash_attention.launches - k4
            stats["worst"] = max(stats["worst"], rel(got[0], want[0]))
            stats["blocks"] += 1
            return got

        def timed(x, wb, c):
            on_ranks = current_mesh() is not None
            if ctx_mesh is not None and not on_ranks:
                return local_moe(x, wb, c)      # checked_block's one rank
            if on_ranks:
                with sharding_ctx(None):
                    want, _ = local_moe(x, wb, c)
                if tag == "ep":
                    stats["single"] += drops(x, wb["router"], own, 1)
                    stats["ep"] += drops(x, wb["router"], own,
                                         mesh.shape["model"])
            sync()
            t0 = time.perf_counter()
            y, aux = local_moe(x, wb, c)
            sync()
            stats["ms"].append(1e3 * (time.perf_counter() - t0))
            if on_ranks:
                stats["worst_moe"] = max(stats["worst_moe"], rel(y, want))
            return y, aux

        moe.moe_ffn = timed
        transformer.block_apply = checked_block
        coll.reset_counts()
        fa.flash_attention.reset_counts()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        try:
            with torch.inference_mode(), sharding_ctx(ctx_mesh):
                logits, _ = transformer.forward(params, tokens, cfg)
        finally:
            moe.moe_ffn = local_moe
            transformer.block_apply = local_block
        L = cfg.n_layers
        ms = sorted(stats["ms"])
        row = {"ms_per_moe_layer": ms[len(ms) // 2],
               "ms_per_moe_layer_all": stats["ms"],
               # the path's own, not its check's one-rank blocks
               "k4_launches": stats["k4"] if ctx_mesh is not None else
               fa.flash_attention.launches,
               "peak_bytes": torch.cuda.max_memory_allocated() if cuda
               else None,
               "collectives_per_layer": {k: [v[0] / L, v[1] / L] for k, v in
                                         coll.COUNTS.items()},
               "blocks_checked": stats["blocks"],
               "worst_block_rel_err": stats["worst"],
               "worst_moe_output_rel_err": stats["worst_moe"]}
        if tag == "ep":
            row["dropped_pairs_own_capacity"] = {"single": stats["single"],
                                                 "ep": stats["ep"]}
        return logits, row

    cf4 = dataclasses.replace(base, capacity_factor=4.0)
    single, report["single"] = run("single", cf4, None)
    for tag, knob in MODES:
        logits, row = run(tag, dataclasses.replace(cf4, **knob), mesh)
        row["logits_rel_err"] = rel(logits, single)
        row["finite"] = bool(torch.isfinite(logits).all())
        report[tag] = row
    with open(os.path.join(out, f"prefill_rank{mesh.rank}.json"), "w") as f:
        json.dump(report, f, indent=1)
    bad = [t for t, _ in MODES if not report[t]["finite"] or
           report[t]["blocks_checked"] != base.n_layers or
           report[t]["worst_block_rel_err"] > PREFILL_TOL]
    if bad:
        raise SystemExit(f"rank {mesh.rank}: the blocks of {bad} differ "
                         f"from one rank's by more than {PREFILL_TOL}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", choices=sorted(WORLDS), required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rank", type=int, default=None,
                    help="run as this rank (the launcher sets it)")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="prefill: the reduced config (a CPU rehearsal)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.rank is None:
        rcs = launch(args.case, args.out, args.device, reduced=args.reduced)
        print(f"{args.case}: ranks exited {rcs}")
        return 0 if all(rc == 0 for rc in rcs) else 1
    if args.case == "prefill" and args.device != "cuda" and \
            not args.reduced:
        raise SystemExit("the full-width prefill case runs on the card")
    world, model = WORLDS[args.case]
    mesh = init_rank(args.rank, world, args.port, args.device, model)
    try:
        if args.case == "equivalence":
            _run_equivalence(mesh, args.out, args.device)
        else:
            _run_prefill(mesh, args.out, args.device, args.reduced)
    finally:
        close_ranks()
    return 0


if __name__ == "__main__":
    sys.exit(main())
