"""Serving example: batched requests through the continuous-batching engine
(prefill + decode steps over the model API's KV caches), the port's twin
of the JAX package's ``examples/serve_lm.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm
      [--arch rwkv6-7b] [--device cpu]
(reduced-size configs so it runs in seconds; on the card a transformer's
prefill attention is the flash-attention kernel, K4, and rwkv6's and
zamba2's recurrences K2 and K3.)
"""
from __future__ import annotations

import argparse

from ..configs import ARCHS
from ..launch.serve import run
from ._device import add_device_arg, on_device


def main(argv=None, emit=print) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-tokens", type=int, default=12)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    cfg = ARCHS[args.arch].reduced()
    with on_device(args.device):
        out = run(cfg, requests=args.requests, slots=args.slots,
                  max_seq=64, max_tokens=args.max_tokens, temperature=0.0,
                  device=args.device, emit=lambda _: None)
    emit(f"arch={args.arch} ({cfg.family}), {out['requests']} requests, "
         f"{out['tokens']} tokens in {out['seconds']:.1f}s "
         f"({out['tok_per_s']:.1f} tok/s, {args.slots} slots, "
         f"{out['device']})")
    for r in sorted(out["done"], key=lambda r: r.rid):
        emit(f"  req{r.rid}: prompt={r.prompt[:4]}... -> {r.output}")
    return out


if __name__ == "__main__":
    main()
