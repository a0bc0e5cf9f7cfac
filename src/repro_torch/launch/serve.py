"""Serving launcher: the continuous-batching engine over a selected
architecture, with weights made from a seed (nothing is downloaded).

Usage:
  EDAN_TORCH_BACKEND=cpu PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch rwkv6-7b                  # the smoke-size config, on the host
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --no-reduced                     # full width, on the card

Archs: rwkv6-7b, zamba2-7b, the transformer families (qwen3-0.6b,
granite-moe-1b-a400m, internvl2-2b, phi3-mini-3.8b; mixtral-8x7b and the
deepseek models need more than one card's memory with float32 masters at
full width) and seamless-m4t-large-v2 (encoder-decoder, over zero frame
embeddings as long as the prompt).  A vlm's prompts are ``n_patches``
placeholder tokens (0), which the patch prefix replaces, then
``prompt_len`` text tokens.

The device comes from ``core.backend.select_backend`` (``cuda`` unless
``$EDAN_TORCH_BACKEND`` or ``device`` says otherwise; ``cuda`` without a
card raises).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ..configs import ARCHS, ModelConfig
from ..core.backend import device_for
from ..models import get_model
from ..serve import Request, ServeEngine


def run(cfg: ModelConfig, requests: int = 8, slots: int = 4,
        max_seq: Optional[int] = None, max_tokens: int = 16,
        temperature: float = 0.0, prompt_len: int = 8,
        device: Optional[str] = None, params=None, emit=print) -> dict:
    """Serve ``requests`` seeded prompts of ``prompt_len`` text tokens (a
    vlm's after its ``n_patches`` placeholders) and return what happened:
    the finished requests, token counts, seconds, the engine's ``stats``
    and the device's name.  ``max_seq`` defaults to the larger of 64 and
    the prompt plus ``max_tokens``; a prompt that does not fit raises.
    Prompts and sampling are seeded with 0; ``params`` are made with
    ``init`` from seed 0 unless given (set-up, not timed)."""
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    total = prefix + prompt_len
    if max_seq is None:
        max_seq = max(64, total + max_tokens)
    if total >= max_seq:
        raise ValueError(f"prompts of {total} tokens do not fit max_seq="
                         f"{max_seq}")
    dev = torch.device(device) if device is not None else device_for()
    api = get_model(cfg)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = api.init(gen, dev)
    eng = ServeEngine(api, params, batch_slots=slots, max_seq=max_seq)
    rng = np.random.default_rng(0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(requests):
        eng.submit(Request(prompt=[0] * prefix + rng.integers(
                               1, 200, size=prompt_len).tolist(),
                           max_tokens=max_tokens,
                           temperature=temperature, rid=i))
    done = eng.run_until_done()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    emit(f"{len(done)} requests, {toks} tokens, {dt:.1f}s "
         f"({toks / dt:.1f} tok/s)")
    return dict(done=done, requests=len(done), tokens=toks, seconds=dt,
                tok_per_s=toks / dt, stats=dict(eng.stats),
                device=(torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the smoke-size config (--no-reduced: the "
                         "full config)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=None,
                    help="cache length (default: the larger of 64 and the "
                         "prompt plus --max-tokens)")
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    run(cfg, requests=args.requests, slots=args.slots, max_seq=args.max_seq,
        max_tokens=args.max_tokens, temperature=args.temperature)


if __name__ == "__main__":
    main()
