"""The sharded train step (``train.train_loop.jit_train_step``) on
``torch.distributed`` ranks: starting the ranks as processes, and the cases
they run against ``configs/shard_expected.json``
(``tools/shard_expected.py``: the reference's ``jit_train_step`` on 8
host devices).

* ``fixture``: 8 ranks on a (2, 4) mesh run every case of the file
  (``CASES``: reduced qwen3-0.6b with 1 and 2 microbatches,
  ``test_dryrun_small.py``'s qwen3, reduced granite-moe-1b-a400m, rwkv6-7b,
  internvl2-2b, zamba2-7b and seamless-m4t-large-v2) for ``STEPS`` steps
  from the file's seeded weights and batches (``case_batches``: a vlm's
  batch carries ``prefix_embeds``, an encdec's ``frame_embeds``); with
  ``--checks``, then reduced qwen3 for one step on a batch with an uneven
  ``mask`` (rank 0 writes the final state, assembled, to ``mask.npz``),
  and one step with ``cast_params_bf16``; then the first case again with
  ``collectives.sum_unnamed`` dropping the sum over ``model`` (the
  ``drop_model_sum`` record), and one step of reduced zamba2 whose gated
  norm drops its sum over ``model`` (``parallel._norm_sum``: the
  ``drop_norm_sum`` record), both of which the tests hold to be caught;
  one step of reduced qwen3 with heads that do not split over ``model``
  (``generic_config``: the generic path); ``first_grads`` of reduced
  ``GRADS_CASE`` (the ``first_grads`` record); then reduced qwen3 at the
  launcher's settings stopped after step ``RESUME_AT`` of
  ``RESUME_STEPS`` under ``ShardedLoop`` into ``<out>/ckpt``, for one
  rank to resume.  Each rank writes
  ``fixture_rank<r>.json``: per run the losses, gradient norms, learning
  rates and collectives, ``summary`` of each of its shards by checkpoint
  key, and of its shards of the first moment after the first step.
* ``full``: each of ``FULL`` (rwkv6-7b, then qwen3-0.6b) at full width,
  its depth cut (``full_config``), float32 masters from seed 0, on 4
  ranks of a (2, 2) mesh: first the gradient of step 1 computed in
  float32 (``first_grads``), then bf16 compute through the launcher's
  ``run`` at its batch of ``FULL_BATCH`` x ``FULL_SEQ`` for ``FULL``'s
  steps under ``ShardedLoop`` into ``<out>/<arch>/ckpt``.  Each rank
  writes ``<out>/<arch>/full_rank<r>.json``: the float32 step 1's loss
  and the norm of each gradient leaf, the losses, gradient norms,
  learning rates and seconds of each step, its peak memory, the
  collectives and their bytes per step, and ``summary`` of each of its
  parameter shards.  On the card the ranks contend for it: their times
  say nothing of four cards.

The ranks are processes on one host (``launch.mesh.spawn_ranks``) in a
``gloo`` world (``launch.mesh.init_rank``).

Usage:
  python -m repro_torch.launch.sharded --case fixture --out DIR
      [--device cpu]
  python -m repro_torch.launch.sharded --case full --out DIR
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

#: the file's mesh, cases, steps, batch and settings
MESH = (2, 4)
CASES = (("qwen3-0.6b", "reduced", 1), ("qwen3-0.6b", "reduced", 2),
         ("qwen3-0.6b", "small", 1), ("granite-moe-1b-a400m", "reduced", 1),
         ("rwkv6-7b", "reduced", 1), ("internvl2-2b", "reduced", 1),
         ("zamba2-7b", "reduced", 1), ("seamless-m4t-large-v2", "reduced", 1))
STEPS = 3
BATCH, SEQ = 8, 32
PARAM_SEED = DATA_SEED = 0
TRAIN = dict(lr=3e-3, warmup_steps=1, total_steps=10)
#: a case's settings beyond ``TRAIN``: rwkv6's seeded init gives its
#: bonus ``u`` a gradient of norm 5.8e5, whose clip would scale every
#: other gradient element to AdamW's ``eps`` (1e-8), where the step
#: measures the rounding of cancelled sums, not the step.  zamba2's clip
#: (its norm 7.9) does the same to fewer elements: with it the
#: reference's own runs on other meshes drift 1.1e-1 in the moments after
#: step 3, without it 1.1e-1 on (8, 1) only and at most 6.6e-3 elsewhere
CASE_TRAIN = {"rwkv6-7b": dict(grad_clip=0.0),
              "zamba2-7b": dict(grad_clip=0.0)}
SLICE = 8
#: the ``--checks`` run whose gated norm drops its sum over ``model``
NORM_CASE = "zamba2-7b"
#: the ``--checks`` run of ``first_grads`` (reduced, float32)
GRADS_CASE = "rwkv6-7b"
#: the ``--checks`` run on the generic path: reduced qwen3 with 6 heads,
#: which do not split over the 4-way ``model`` axis
GENERIC_HEADS = 6
#: the resume run: the launcher's reduced qwen3 at these settings,
#: stopped after RESUME_AT of RESUME_STEPS steps
RESUME_STEPS, RESUME_AT, RESUME_BATCH, RESUME_SEQ = 3, 2, 8, 16
#: each case's world and model-axis size
WORLDS = {"fixture": (MESH[0] * MESH[1], MESH[1]), "full": (4, 2)}
#: the full-width runs: arch -> (layers, steps).  rwkv6-7b's 32 layers
#: are cut to 4 (1.41B parameters): the whole model's float32 masters and
#: two AdamW moments, 7.6B x 12 bytes, exceed the card's 80 GB.  qwen3's
#: 28 are cut to 4, and its steps to 1, to keep ``chip_smoke.py`` within
#: its time.
FULL = {"rwkv6-7b": (4, 2), "qwen3-0.6b": (4, 1)}
#: the full-width runs' global batch and sequence: the launcher's defaults
FULL_BATCH, FULL_SEQ = 8, 128


def case_name(arch: str, size: str, microbatches: int) -> str:
    return f"{arch}:{size}:mb{microbatches}"


def case_train(arch: str, microbatches: int, train_config):
    """The case's ``TrainConfig`` (either package's class)."""
    return train_config(microbatches=microbatches,
                        **{**TRAIN, **CASE_TRAIN.get(arch, {})})


def case_config(arch: str, size: str, archs):
    """The case's config from ``archs`` (either package's ``ARCHS``):
    ``cfg.reduced()``, or for size ``"small"`` ``test_dryrun_small.py``'s
    qwen3 (3 layers, d 128, 8 heads, 4 KV heads, vocabulary 512) in
    float32."""
    cfg = archs[arch].reduced()
    if size == "small":
        cfg = dataclasses.replace(cfg, n_layers=3, d_model=128, n_heads=8,
                                  n_kv_heads=4, head_dim=16, d_ff=256,
                                  vocab_size=512)
    return cfg


def full_config(arch: str, archs):
    """A full-width run's config from ``archs``: every width of the
    published config, its depth cut to ``FULL``'s."""
    return dataclasses.replace(archs[arch], n_layers=FULL[arch][0])


def generic_config(archs):
    """The ``--checks`` generic-path config from ``archs``."""
    return dataclasses.replace(archs["qwen3-0.6b"].reduced(),
                               n_heads=GENERIC_HEADS)


def case_batches(cfg, data_cls) -> list:
    """A case's ``STEPS`` batches (numpy): the tokens and labels of
    ``data_cls`` (either package's ``SyntheticLMData``) seeded with
    ``DATA_SEED``, and for a vlm standard-normal ``prefix_embeds``
    (``BATCH``, n_patches, d), for an encdec ``frame_embeds`` (``BATCH``,
    ``SEQ``, d), float32, drawn step by step from one numpy generator
    seeded with ``DATA_SEED``."""
    data = data_cls(vocab_size=cfg.padded_vocab(), seq_len=SEQ,
                    global_batch=BATCH, seed=DATA_SEED)
    rng = np.random.default_rng(DATA_SEED)
    out = []
    for s in range(STEPS):
        b = dict(data.batch(s))
        if cfg.family == "vlm":
            b["prefix_embeds"] = rng.standard_normal(
                (BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            b["frame_embeds"] = rng.standard_normal(
                (BATCH, SEQ, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def summary(x) -> dict:
    """A shard's record: shape, float64 sum of squares, ``SLICE`` evenly
    spaced values of it, flattened."""
    a = np.asarray(x, np.float32)
    flat = a.ravel()
    idx = np.linspace(0, flat.size - 1, min(SLICE, flat.size)).astype(int)
    return {"shape": list(a.shape),
            "sumsq": float(np.sum(flat.astype(np.float64) ** 2)),
            "vals": flat[idx].tolist()}


def summaries(state) -> dict:
    """{checkpoint key: ``summary``} of a state ``{"params", "opt"}``,
    the optimizer's step counter left out."""
    from ..train import checkpoint as ckpt
    return {k: summary(v.detach().cpu().numpy())
            for k, v in ckpt._flatten(state).items() if k != "opt/.step"}


def first_moments(opt) -> dict:
    """``summaries`` of the AdamW first moment of ``opt`` (after the first
    step: the clipped gradient)."""
    return {k: v for k, v in summaries({"opt": opt}).items()
            if k.startswith("opt/.mu/")}


def masked_batch(cfg, seed: int = 3) -> dict:
    """A seeded batch of ``BATCH`` x ``SEQ`` tokens with an uneven
    ``mask``: row r keeps its first ``4 + 3 r`` positions."""
    rng = np.random.default_rng(seed)
    V = cfg.padded_vocab()
    out = {k: rng.integers(0, V, (BATCH, SEQ)).astype(np.int32)
           for k in ("tokens", "labels")}
    out["mask"] = (np.arange(SEQ)[None] < 4 + 3 * np.arange(BATCH)[:, None]
                   ).astype(np.float32)
    return out


def launch(case: str, out: str, device: str = "cuda",
           timeout: float = 600.0, checks: bool = False) -> list:
    """Run ``case`` on its ranks (``fixture`` with ``checks``: the mask,
    dropped-sum and resume runs too); return their exit codes."""
    return spawn_ranks("repro_torch.launch.sharded",
                       ["--case", case, "--out", out, "--device", device] +
                       (["--checks"] if checks else []), WORLDS[case][0],
                       timeout)


# ------------------------------------------------------------- fixture

def _train(mesh, cfg, tc, batches, device, assemble_to=None) -> dict:
    """``jit_train_step`` for ``len(batches)`` steps from the file's
    seeded weights; returns the metrics and this rank's shards' records.
    With ``assemble_to`` rank 0 also writes the final state, assembled
    (``assemble_tree``), to that ``.npz`` file."""
    import torch
    from ..models import get_model
    from ..models.module import init_params_numpy, params_from_numpy
    from ..models.parallel import rank_rows
    from ..train.optimizer import adamw_init
    from ..train.train_loop import jit_train_step, shard_tree
    api = get_model(cfg)
    step, pspecs, _, _ = jit_train_step(api, tc, mesh)
    params = shard_tree(params_from_numpy(
        init_params_numpy(api.specs(), PARAM_SEED), device), pspecs, mesh)
    opt = adamw_init(params)
    rows = rank_rows(len(batches[0]["tokens"]), mesh, tc.microbatches)
    out = dict(loss=[], grad_norm=[], lr=[], path=step.path)
    for b in batches:
        b = {k: torch.from_numpy(v[rows]).to(device) for k, v in b.items()}
        params, opt, m = step(params, opt, b)
        for k in ("loss", "grad_norm", "lr"):
            out[k].append(float(m[k]))
        if "first_mu" not in out:
            out["first_mu"] = first_moments(opt)
    out["shards"] = summaries({"params": params, "opt": opt})
    if assemble_to is not None:
        from ..train import checkpoint as ckpt
        from ..train.train_loop import assemble_tree, shardings_for_train
        _, opt_specs = shardings_for_train(api, mesh)[:2]
        full = assemble_tree({"params": params, "opt": opt},
                             {"params": pspecs, "opt": opt_specs}, mesh)
        if mesh.rank == 0:
            np.savez(assemble_to, **{k: v.numpy() for k, v in
                                     ckpt._flatten(full).items()})
    return out


def _run_fixture(mesh, out: str, device: str, checks: bool) -> None:
    import torch
    from ..configs import ARCHS, TrainConfig
    from ..data import SyntheticLMData
    from ..sharding import collectives as coll
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    res, t0 = {"coords": mesh.coords, "device": device}, time.perf_counter()

    def batches(cfg):
        return case_batches(cfg, SyntheticLMData)

    runs = {}
    for arch, size, mb in CASES:
        cfg = case_config(arch, size, ARCHS)
        coll.reset_counts()
        runs[case_name(arch, size, mb)] = dict(_train(
            mesh, cfg, case_train(arch, mb, TrainConfig), batches(cfg),
            device), collectives={k: list(v) for k, v in
                                  coll.COUNTS.items()})
    if checks:
        _run_checks(mesh, out, device, runs, batches)
    res["runs"], res["seconds"] = runs, time.perf_counter() - t0
    with open(os.path.join(out, f"fixture_rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f)


def _run_checks(mesh, out: str, device: str, runs: dict, batches) -> None:
    from ..configs import ARCHS, TrainConfig
    from ..models import parallel
    from ..sharding import collectives as coll
    from . import train as launcher
    cfg = ARCHS["qwen3-0.6b"].reduced()
    runs["mask"] = _train(mesh, cfg, TrainConfig(**TRAIN),
                          [masked_batch(cfg)], device,
                          assemble_to=os.path.join(out, "mask.npz"))
    runs["cast_bf16"] = _train(
        mesh, cfg, TrainConfig(cast_params_bf16=True, **TRAIN),
        batches(cfg)[:1], device)
    arch, size, mb = CASES[0]
    cfg = case_config(arch, size, ARCHS)
    keep = coll.sum_unnamed
    coll.sum_unnamed = lambda g, m, axes: keep(
        g, m, [a for a in axes if a != "model"])
    try:
        runs["drop_model_sum"] = _train(
            mesh, cfg, case_train(arch, mb, TrainConfig), batches(cfg),
            device)
    finally:
        coll.sum_unnamed = keep
    cfg = case_config(NORM_CASE, "reduced", ARCHS)
    keep = parallel._norm_sum
    parallel._norm_sum = lambda ss, mg: ss
    try:
        runs["drop_norm_sum"] = _train(
            mesh, cfg, case_train(NORM_CASE, 1, TrainConfig),
            batches(cfg)[:1], device)
    finally:
        parallel._norm_sum = keep
    cfg = generic_config(ARCHS)
    runs["generic"] = _train(mesh, cfg, TrainConfig(**TRAIN),
                             batches(cfg)[:1], device)
    runs["first_grads"] = first_grads(
        case_config(GRADS_CASE, "reduced", ARCHS), device, mesh)
    launcher.run(
        ARCHS["qwen3-0.6b"].reduced(), mesh=mesh, steps=RESUME_STEPS,
        global_batch=RESUME_BATCH, seq=RESUME_SEQ,
        ckpt_dir=os.path.join(out, "ckpt"), save_every=0, keep=1,
        device=device, emit=lambda m: None, stop_after=RESUME_AT)


def first_grads(cfg, device: str, mesh=None) -> dict:
    """Step 1 of the launcher's run of ``cfg`` without its update: the
    loss and ``{checkpoint key: norm}`` of the gradient's leaves, from
    the parameters of ``api.init`` with ``TrainConfig.seed`` and batch 0
    of ``FULL_BATCH`` x ``FULL_SEQ`` tokens, as ``launch.train.run``
    makes them; on this rank's shards and rows with ``mesh`` (a
    ``RankMesh``; the sharded step's gradient), else on one process
    (``make_train_step``'s)."""
    import torch
    from ..configs import TrainConfig
    from ..data import SyntheticLMData
    from ..kernels import ops
    from ..models import get_model
    from ..models.module import value_and_grad
    from ..models.parallel import rank_rows
    from ..train.train_loop import jit_train_step, leaf_norms, shard_tree
    api, tc, dev = get_model(cfg), TrainConfig(), torch.device(device)
    params = api.init(torch.Generator(device=dev).manual_seed(tc.seed), dev)
    data = SyntheticLMData(vocab_size=cfg.padded_vocab(), seq_len=FULL_SEQ,
                           global_batch=FULL_BATCH, seed=tc.seed)
    rows, pspecs = slice(None), None
    if mesh is None:
        def loss(p, b):
            with ops.differentiable():
                return api.loss_fn(p, b)
        grads_fn = value_and_grad(loss)
    else:
        step, pspecs, _, _ = jit_train_step(api, tc, mesh)
        params = shard_tree(params, pspecs, mesh)
        rows, grads_fn = rank_rows(FULL_BATCH, mesh), step.grads
    b = {k: torch.from_numpy(v[rows]).to(dev)
         for k, v in data.batch(0).items()}
    value, grads = grads_fn(params, b)
    return dict(loss=float(value), grad_norms=leaf_norms(grads, pspecs, mesh))


def _run_full(mesh, out: str, device: str) -> None:
    import gc
    import torch
    from ..configs import ARCHS
    from ..sharding import collectives as coll
    from . import train as launcher
    cuda = device == "cuda"
    for arch in FULL:
        cfg = full_config(arch, ARCHS)
        t0 = time.perf_counter()
        f32 = first_grads(dataclasses.replace(cfg, dtype="float32"), device,
                          mesh)
        f32["seconds"] = time.perf_counter() - t0
        if cuda:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        coll.reset_counts()
        os.makedirs(os.path.join(out, arch), exist_ok=True)
        res = launcher.run(
            cfg, mesh=mesh, steps=FULL[arch][1], global_batch=FULL_BATCH,
            seq=FULL_SEQ, ckpt_dir=os.path.join(out, arch, "ckpt"),
            save_every=0, keep=1, device=device,
            emit=lambda m: print(m, flush=True))
        n = len(res["step"])
        # the checkpoints' assembly is labelled "assemble"; the rest is
        # steps
        per_step = {k: [v[0] / n, v[1] / n] for k, v in coll.COUNTS.items()
                    if k != "assemble"}
        rep = dict(rank=mesh.rank, coords=mesh.coords, mesh=dict(mesh.shape),
                   arch=arch, n_layers=cfg.n_layers, first_f32=f32,
                   path=res["path"], n_params=res["n_params"],
                   loss=res["loss"], grad_norm=res["grad_norm"], lr=res["lr"],
                   seconds=res["seconds"], seconds_total=res["seconds_total"],
                   collectives_per_step=per_step,
                   checkpoint_collectives=coll.COUNTS.get("assemble"),
                   peak_bytes=torch.cuda.max_memory_allocated() if cuda
                   else None,
                   device=torch.cuda.get_device_name(0) if cuda else "cpu",
                   params=summaries({"params": res["state"]["params"]}))
        with open(os.path.join(out, arch, f"full_rank{mesh.rank}.json"),
                  "w") as f:
            json.dump(rep, f)
        del res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", choices=sorted(WORLDS), required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--checks", action="store_true",
                    help="fixture: the mask, dropped-sum and resume runs")
    ap.add_argument("--rank", type=int, default=None,
                    help="run as this rank (the launcher sets it)")
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.rank is None:
        rcs = launch(args.case, args.out, args.device, checks=args.checks)
        print(f"{args.case}: ranks exited {rcs}")
        return 0 if all(rc == 0 for rc in rcs) else 1
    if args.case == "full" and args.device != "cuda":
        raise SystemExit("the full-width case runs on the card")
    world, model = WORLDS[args.case]
    mesh = init_rank(args.rank, world, args.port, args.device, model)
    try:
        if args.case == "fixture":
            _run_fixture(mesh, args.out, args.device, args.checks)
        else:
            _run_full(mesh, args.out, args.device)
    finally:
        close_ranks()
    return 0


if __name__ == "__main__":
    sys.exit(main())
