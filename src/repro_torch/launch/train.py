"""Training launcher: config -> parameters and optimizer state on one
device -> deterministic data -> the train step -> the fault-tolerant loop
with periodic checkpoints, the port's counterpart of the reference
package's ``launch/train.py`` with its flags and defaults.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train          # qwen3-0.6b at
                                   # full width on the card, 50 steps
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 3 \\
      --device cpu                 # the smoke-size config on the host

One card has no production mesh: ``--production-mesh`` and
``--multi-pod`` (the reference's SPMD layouts over 256 and 512 chips)
exit; the port's dry-run takes those meshes instead, a cell at a time:
``python -m repro_torch.launch.dryrun --cell ARCH SHAPE pod|multipod``.
The reference's ``--model-parallel`` has nothing to split on one card and
is not taken.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from ..configs import ARCHS, ModelConfig, TrainConfig
from ..core.backend import device_for
from ..data import SyntheticLMData
from ..launch.mesh import make_host_mesh
from ..models import get_model
from ..train.fault import FaultTolerantLoop
from ..train.optimizer import adamw_init
from ..train.train_loop import make_train_step

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(),
                                "repro_torch_launch_train")


def run(cfg: ModelConfig, *, steps: int = 50, global_batch: int = 8,
        seq: int = 128, microbatches: int = 1,
        ckpt_dir: str = DEFAULT_CKPT_DIR, save_every: int = 25,
        keep: int = 3, device: Optional[str] = None,
        inject_failure: Optional[Callable[[int], bool]] = None,
        emit=print) -> dict:
    """Train ``cfg`` for ``steps`` steps under ``FaultTolerantLoop``
    (resuming from ``ckpt_dir`` when it holds a checkpoint) and return
    what happened: per-step losses, gradient norms, learning rates and
    seconds of every step run (replays included), the loop's restarts and
    straggler flags, the final state and the seconds of the whole loop.
    Parameters come from ``api.init`` with ``TrainConfig.seed`` (0)."""
    dev = torch.device(device) if device is not None else device_for()
    api = get_model(cfg)
    tc = TrainConfig(total_steps=steps, warmup_steps=max(steps // 10, 1),
                     microbatches=microbatches, checkpoint_dir=ckpt_dir)
    step = make_train_step(api, tc)
    params = api.init(torch.Generator(device=dev).manual_seed(tc.seed), dev)
    opt = adamw_init(params)
    data = SyntheticLMData(vocab_size=cfg.padded_vocab(), seq_len=seq,
                           global_batch=global_batch, seed=tc.seed)
    emit(f"arch={cfg.name} ({api.n_params() / 1e6:.1f}M params), "
         f"mesh={make_host_mesh().shape}, device={dev}")
    log = dict(step=[], loss=[], grad_norm=[], lr=[], seconds=[])

    def step_fn(state, s):
        t0 = time.perf_counter()
        b = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(s).items()}
        p, o, m = step(state["params"], state["opt"], b)
        vals = {k: float(v) for k, v in m.items()}    # waits for the step
        log["step"].append(s)
        for k in ("loss", "grad_norm", "lr"):
            log[k].append(vals[k])
        log["seconds"].append(time.perf_counter() - t0)
        if s % 10 == 0:
            emit(f"step {s:5d}  loss {vals['loss']:.4f}  "
                 f"gnorm {vals['grad_norm']:.3f}")
        return {"params": p, "opt": o}

    loop = FaultTolerantLoop({"params": params, "opt": opt}, ckpt_dir,
                             save_every=save_every, keep=keep, device=dev,
                             inject_failure=inject_failure)
    del params, opt
    t0 = time.perf_counter()
    state = loop.run(step_fn, steps)
    dt = time.perf_counter() - t0
    emit(f"done: {steps} steps, {dt:.0f}s, {loop.restarts} restarts, "
         f"{loop.straggler.flagged} straggler steps flagged")
    return dict(log, state=state, restarts=loop.restarts,
                stragglers=loop.straggler.flagged, start_step=loop.start_step,
                seconds_total=dt, n_params=api.n_params(), device=str(dev))


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
    run(cfg, steps=args.steps, global_batch=args.global_batch, seq=args.seq,
        microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
        save_every=args.save_every, device=args.device)


if __name__ == "__main__":
    main()
