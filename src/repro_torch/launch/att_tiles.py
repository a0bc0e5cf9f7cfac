"""The K/V tile size of K4's bf16 kernel, measured: 64 against 128 keys.

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.att_tiles

Builds ``csrc/flash_attention.cu`` twice, with ``kTcBKV`` (keys per K/V
tile of the bf16 kernel) set to 64 and to 128 in copies under ``build/``,
and for each: prints ptxas's register report, holds it to
``flash_attention_plain(round_p=True)`` (the largest |Δ| over the
largest |plain|) at the served prefill shapes and at grids of more than
one wave (256 and 512 CTAs on 132 SMs), and times it there by the
kernel's own device time under ``torch.profiler`` (20 launches after one
warm-up), the two sizes in turns (64, 128, 128, 64) and averaged.  Last,
one JSON line of every shape's device µs per size.  Nothing here is on a
served path: it is the measurement behind the kernel's choice.
"""
from __future__ import annotations

import json
import subprocess

import torch

from ..kernels.cuda_build import BUILD_DIR, CSRC
from ..kernels.flash_attention import FlashAttentionKernel
from ..kernels.ref import flash_attention_plain

SIZES = (64, 128)
#: (label, B, T, H, KV, hd), causal bf16: the served prefill shapes, then
#: grids of 256 and 512 CTAs
SHAPES = (("qwen3-0.6b", 1, 128, 16, 8, 128),
          ("granite-moe-1b-a400m", 1, 128, 16, 8, 64),
          ("internvl2-2b", 1, 384, 16, 8, 128),
          ("zamba2-7b", 1, 128, 32, 32, 112),
          ("T=1024 hd=128", 1, 1024, 16, 8, 128),
          ("T=2048 hd=128", 1, 2048, 16, 8, 128),
          ("B=4 T=512 hd=128", 4, 512, 16, 8, 128),
          ("T=2048 hd=64", 1, 2048, 16, 8, 64))


def variant_source(bkv: int) -> str:
    """``csrc/flash_attention.cu`` with ``bkv`` keys per bf16 tile."""
    src = (CSRC / "flash_attention.cu").read_text()
    lines = [ln for ln in src.splitlines()
             if ln.startswith("constexpr int kTcBKV = ")]
    if len(lines) != 1:
        raise RuntimeError("flash_attention.cu: no single kTcBKV line")
    return src.replace(lines[0], f"constexpr int kTcBKV = {bkv};")


def variant(bkv: int) -> FlashAttentionKernel:
    """The wrapper over a copy of the source (under ``build/``) whose bf16
    tiles hold ``bkv`` keys."""
    out = BUILD_DIR / f"att_tiles_{bkv}"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "flash_attention.cu"
    path.write_text(variant_source(bkv))
    kern = FlashAttentionKernel()
    kern.lib.src = path
    return kern


def device_us(fn, reps: int = 20) -> float:
    """The CUDA kernels' device µs per call of ``fn`` under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = sum(ev.self_device_time_total for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA)
    return dev / reps


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    kerns = {bkv: variant(bkv) for bkv in SIZES}
    for bkv, kern in kerns.items():
        kern.build()
        print(f"kTcBKV={bkv}:", *(ln.strip() for ln in
                                  kern.build_log.splitlines()
                                  if "registers" in ln), sep="\n  ")
    g = torch.Generator(device="cuda").manual_seed(9)
    times = {}
    for label, B, T, H, KV, hd in SHAPES:
        q = torch.randn(B, T, H, hd, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(B, T, KV, hd, generator=g,
                            device="cuda").bfloat16() for _ in range(2))
        ref = flash_attention_plain(q, k, v, block_kv=64, round_p=True)
        scale = ref.float().abs().max().item()
        errs = {bkv: (kern(q, k, v).float() - ref.float()).abs().max().item()
                / scale for bkv, kern in kerns.items()}
        us = {bkv: [] for bkv in SIZES}
        for bkv in SIZES + SIZES[::-1]:
            us[bkv].append(device_us(lambda: kerns[bkv](q, k, v)))
        times[label] = {bkv: sum(x) / len(x) for bkv, x in us.items()}
        print(f"{label} (B={B} T={T} H={H} KV={KV} hd={hd}, "
              f"{B * H * -(-T // 64)} CTAs): device µs "
              f"{times[label]}, |Δ| vs round_p {errs}", flush=True)
    print(json.dumps({"device_us": times}))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("att_tiles: no CUDA device")
    main()
