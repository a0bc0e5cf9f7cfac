"""End to end: train a small LM on synthetic data with the port's
training stack — AdamW, gradient accumulation, periodic checkpoints,
fault-tolerant resume — and a final EDAN analysis of the step, the port's
twin of the JAX package's ``examples/train_lm.py``.

One card holds every parameter whole (no sharded params).  The step is
captured abstractly by the PyTorch-graph frontend (``core.fxgraph``, on
``meta`` tensors) and its eDAG's depths run the level kernel (K1) on the
card, or its plain version with ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
      --scale 10m [--device cpu]
      (--scale 100m for the full-size example; --scale tiny --steps 3 is
      the tests' size)
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

from ..configs import ARCHS, TrainConfig
from ..data import SyntheticLMData
from ..models import get_model
from ..models.module import abstract_params
from ..train.fault import FaultTolerantLoop
from ..train.optimizer import adamw_init
from ..train.train_loop import make_train_step
from ._device import add_device_arg, on_device

SCALES = {
    # ~10M / ~100M params: the qwen3 family scaled down, as the reference's
    "tiny": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                 head_dim=16, d_ff=128, vocab_size=512),
    "10m": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                head_dim=64, d_ff=1024, vocab_size=8192),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 head_dim=64, d_ff=3072, vocab_size=32768),
}


def main(argv=None, emit=print) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", choices=SCALES, default="10m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = replace(ARCHS["qwen3-0.6b"], **SCALES[args.scale], qk_norm=True,
                  dtype="float32", remat="block", attn_chunk_kv=128)
    api = get_model(cfg)
    emit(f"model: {api.n_params() / 1e6:.1f}M params "
         f"({cfg.n_layers}L d={cfg.d_model}), device {dev}")
    tc = TrainConfig(lr=3e-4, warmup_steps=20,
                     total_steps=args.steps,
                     microbatches=args.microbatches)
    params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    step = make_train_step(api, tc)
    data = SyntheticLMData(vocab_size=cfg.padded_vocab(), seq_len=args.seq,
                           global_batch=args.batch, seed=0)
    losses = []

    def step_fn(state, s):
        b = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(s).items()}
        p, o, m = step(state["params"], state["opt"], b)
        losses.append(float(m["loss"]))
        if s % 10 == 0:
            emit(f"step {s:5d}  loss {float(m['loss']):.4f}  "
                 f"gnorm {float(m['grad_norm']):.3f}  "
                 f"lr {float(m['lr']):.2e}")
        return {"params": p, "opt": o}

    with on_device(args.device):
        loop = FaultTolerantLoop({"params": params, "opt": adamw_init(params)},
                                 args.ckpt_dir, save_every=args.save_every,
                                 device=dev)
        t0 = time.perf_counter()
        loop.run(step_fn, args.steps)
        dt = time.perf_counter() - t0
        done = args.steps - loop.start_step
        emit(f"\ntrained {done} steps in {dt:.0f}s "
             f"({dt / max(done, 1):.2f}s/step); "
             f"loss {losses[0] if losses else float('nan'):.3f} -> "
             f"{np.mean(losses[-10:]) if losses else float('nan'):.3f}")

        # the paper's loop, closed: analyze our own step
        from ..core import CostModelParams, edag_from_fn, report
        b = {k: torch.from_numpy(v).to("meta")
             for k, v in data.batch(0).items()}
        g = edag_from_fn(lambda p: api.loss_fn(p, b),
                         abstract_params(api.specs()),
                         mem_threshold_bytes=1 << 20, scan_unroll_limit=4)
        r = report(g, CostModelParams(m=8, alpha=200.0))
    emit(f"EDAN on this step: {g.n_vertices} vertices, W={r.W}, D={r.D}, "
         f"lambda={r.lam:.0f}, parallelism={r.parallelism:.0f}")
    return dict(losses=losses, steps=done, seconds=dt, edag=g, report=r,
                n_params=api.n_params())


if __name__ == "__main__":
    main()
