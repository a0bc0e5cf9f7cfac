"""Training launcher: config -> parameters and optimizer state -> the
deterministic data -> the train step -> the fault-tolerant loop with
periodic checkpoints, the port's counterpart of the reference package's
``launch/train.py`` with its flags and defaults.

With ``--ranks 1`` (the default) one process trains on one device with
``make_train_step``.  With ``--ranks N`` the launcher starts N processes,
the ranks of a ``gloo`` ``torch.distributed`` world (all on the one card,
or on the host with ``--device cpu``), on the (data, model) mesh
``make_rank_mesh(--model-parallel)``; each rank runs (``run(...,
mesh=...)``) ``jit_train_step`` on its shards under ``ShardedLoop``,
whose checkpoints
are the full tree that a single-rank run writes, so either resumes the
other's.  Every rank builds the global batch of ``SyntheticLMData`` with
``process_index=0, process_count=1``, as the reference's single-host
launcher does, and takes its rows (``models.parallel.rank_rows``); the
parameters are ``api.init`` of ``TrainConfig.seed`` on every rank, cut
into its shards.  Rank 0 reports.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train          # qwen3-0.6b at
                                   # full width on the card, 50 steps
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 3 \\
      --device cpu                 # the smoke-size config on the host
  PYTHONPATH=src python -m repro_torch.launch.train --ranks 8 \\
      --model-parallel 4 --reduced --steps 3 --device cpu    # (2, 4) mesh

``--production-mesh`` and ``--multi-pod`` (the reference's SPMD layouts
over 256 and 512 chips) exit; the port's dry-run takes those meshes
instead, a cell at a time: ``python -m repro_torch.launch.dryrun --cell
ARCH SHAPE pod|multipod``.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from functools import partial
from typing import Callable, Optional

import torch

from ..configs import ARCHS, ModelConfig, TrainConfig
from ..core.backend import device_for
from ..data import SyntheticLMData
from ..launch.mesh import (close_ranks, init_rank, make_host_mesh,
                           spawn_ranks)
from ..models import get_model
from ..models.parallel import rank_rows
from ..train.fault import FaultTolerantLoop, ShardedLoop
from ..train.optimizer import adamw_init
from ..train.train_loop import jit_train_step, make_train_step, shard_tree

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(),
                                "repro_torch_launch_train")


def run(cfg: ModelConfig, *, steps: int = 50, global_batch: int = 8,
        seq: int = 128, microbatches: int = 1,
        ckpt_dir: str = DEFAULT_CKPT_DIR, save_every: int = 25,
        keep: int = 3, device: Optional[str] = None,
        inject_failure: Optional[Callable[[int], bool]] = None,
        emit=print, stop_after: Optional[int] = None, mesh=None) -> dict:
    """Train ``cfg`` for ``steps`` steps under ``FaultTolerantLoop``
    (resuming from ``ckpt_dir`` when it holds a checkpoint) and return
    what happened: per-step losses, gradient norms, learning rates and
    seconds of every step run (replays included), the loop's restarts and
    straggler flags, the final state and the seconds of the whole loop.
    Parameters come from ``api.init`` with ``TrainConfig.seed`` (0).
    ``stop_after`` ends the loop (and writes its checkpoint) after that
    step of a ``steps``-step schedule, as a preemption would.

    With ``mesh`` (a ``RankMesh``) this process is one rank: the sharded
    step (``jit_train_step``) on its shards and batch rows under
    ``ShardedLoop``; the state returned is its shards, the metrics the
    global values, and only rank 0 calls ``emit``."""
    dev = torch.device(device) if device is not None else device_for()
    api = get_model(cfg)
    tc = TrainConfig(total_steps=steps, warmup_steps=max(steps // 10, 1),
                     microbatches=microbatches, checkpoint_dir=ckpt_dir)
    params = api.init(torch.Generator(device=dev).manual_seed(tc.seed), dev)
    data = SyntheticLMData(vocab_size=cfg.padded_vocab(), seq_len=seq,
                           global_batch=global_batch, seed=tc.seed)
    if mesh is None:
        step, rows, say = make_train_step(api, tc), slice(None), emit
        where = f"mesh={make_host_mesh().shape}, device={dev}"
        loop_cls, path = FaultTolerantLoop, None
    else:
        step, pspecs, opt_specs, _ = jit_train_step(api, tc, mesh)
        params = shard_tree(params, pspecs, mesh)
        rows = rank_rows(global_batch, mesh, microbatches)
        say = emit if mesh.rank == 0 else (lambda _: None)
        where = (f"mesh={dict(mesh.shape)}, device={dev}, "
                 f"ranks={mesh.size}, path={step.path}")
        loop_cls = partial(ShardedLoop, mesh=mesh, specs={
            "params": pspecs, "opt": opt_specs})
        path = step.path
    opt = adamw_init(params)
    say(f"arch={cfg.name} ({api.n_params() / 1e6:.1f}M params), {where}")
    log = dict(step=[], loss=[], grad_norm=[], lr=[], seconds=[])

    def step_fn(state, s):
        t0 = time.perf_counter()
        b = {k: torch.from_numpy(v[rows]).to(dev)
             for k, v in data.batch(s).items()}
        p, o, m = step(state["params"], state["opt"], b)
        vals = {k: float(v) for k, v in m.items()}    # waits for the step
        log["step"].append(s)
        for k in ("loss", "grad_norm", "lr"):
            log[k].append(vals[k])
        log["seconds"].append(time.perf_counter() - t0)
        if s % 10 == 0:
            say(f"step {s:5d}  loss {vals['loss']:.4f}  "
                f"gnorm {vals['grad_norm']:.3f}")
        return {"params": p, "opt": o}

    loop = loop_cls({"params": params, "opt": opt}, ckpt_dir,
                    save_every=save_every, keep=keep, device=dev,
                    inject_failure=inject_failure)
    del params, opt
    t0 = time.perf_counter()
    state = loop.run(step_fn, steps if stop_after is None else stop_after)
    dt = time.perf_counter() - t0
    say(f"done: {steps} steps, {dt:.0f}s, {loop.restarts} restarts, "
        f"{loop.straggler.flagged} straggler steps flagged")
    return dict(log, state=state, restarts=loop.restarts,
                stragglers=loop.straggler.flagged, start_step=loop.start_step,
                seconds_total=dt, n_params=api.n_params(), device=str(dev),
                path=path)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="smoke-scale config (dev boxes)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the model axis of the rank mesh (--ranks > 1)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="gloo processes, the ranks of a (data, model) mesh")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # set by the launcher
    ap.add_argument("--port", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's 16x16 pod mesh (not on one card)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.production_mesh or args.multi_pod:
        raise SystemExit("--production-mesh / --multi-pod: the port trains "
                         "on one card; for a production mesh run the "
                         "dry-run: python -m repro_torch.launch.dryrun "
                         "--cell ARCH SHAPE pod|multipod")
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    kw = dict(steps=args.steps, global_batch=args.global_batch,
              seq=args.seq, microbatches=args.microbatches,
              ckpt_dir=args.ckpt_dir, save_every=args.save_every,
              device=args.device)
    if args.ranks <= 1:
        run(cfg, **kw)
        return 0
    if args.rank is None:
        rcs = spawn_ranks("repro_torch.launch.train",
                          list(sys.argv[1:] if argv is None else argv),
                          args.ranks)
        if any(rcs):
            raise SystemExit(f"ranks exited {rcs}")
        return 0
    mesh = init_rank(args.rank, args.ranks, args.port,
                     args.device or device_for().type, args.model_parallel)
    try:
        run(cfg, mesh=mesh, **kw)
    finally:
        close_ranks()
    return 0


if __name__ == "__main__":
    sys.exit(main())
