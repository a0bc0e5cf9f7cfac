"""Configurations of the port.

* ``ARCHS`` / ``get_config``: the model zoo's architectures, one module
  each, copied as plain data from the reference package (``base.py`` holds
  ``ModelConfig`` and ``ShapeConfig``).  The port serves the ``ssm``
  (rwkv6-7b) and ``hybrid`` (zamba2-7b) families; the others are named so
  that ``get_config`` knows every architecture.
* ``paper_suite``: the paper's own workload settings, and
  ``paper_expected.json`` the reference package's paper-size results the
  port is held to.
* ``serve_expected.json``: the reference package's logits and greedy
  tokens on the two small serving fixtures (``tools/serve_expected.py``).
"""
from .base import ModelConfig, ShapeConfig

from .deepseek_67b import CONFIG as deepseek_67b
from .deepseek_coder_33b import CONFIG as deepseek_coder_33b
from .qwen3_0_6b import CONFIG as qwen3_0_6b
from .phi3_mini_3_8b import CONFIG as phi3_mini_3_8b
from .internvl2_2b import CONFIG as internvl2_2b
from .mixtral_8x7b import CONFIG as mixtral_8x7b
from .granite_moe_1b import CONFIG as granite_moe_1b
from .rwkv6_7b import CONFIG as rwkv6_7b
from .seamless_m4t_large_v2 import CONFIG as seamless_m4t_large_v2
from .zamba2_7b import CONFIG as zamba2_7b

ARCHS = {
    c.name: c for c in [
        deepseek_67b, deepseek_coder_33b, qwen3_0_6b, phi3_mini_3_8b,
        internvl2_2b, mixtral_8x7b, granite_moe_1b, rwkv6_7b,
        seamless_m4t_large_v2, zamba2_7b,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ModelConfig", "ShapeConfig", "ARCHS", "get_config"]
