"""The PolyBench kernels of a configuration, traced by the program at size
``N`` with no cache; ``seed`` draws each kernel's inputs."""
from __future__ import annotations

from repro_torch.apps.polybench import trace_kernel


def build(cfg: dict, seed: int) -> dict:
    out = {}
    for name in cfg["kernels"]:
        g = trace_kernel(name, int(cfg["N"]), seed=seed)
        g._finalize()
        out[name] = g
    return out
