"""Configurations of the port.

* ``ARCHS`` / ``get_config``: the model zoo's architectures, one module
  each, copied as plain data from the reference package (``base.py`` holds
  ``ModelConfig``, ``ShapeConfig``, ``SHAPES``, ``shape_applicable`` and
  ``TrainConfig``).  The port builds all six families (``dense``, ``moe``,
  ``vlm``, ``ssm``, ``hybrid``, ``encdec``) at every width.
* ``paper_suite``: the paper's own workload settings, and
  ``paper_expected.json`` the reference package's paper-size results the
  port is held to.
* ``serve_expected.json``: the reference package's logits and greedy
  tokens on six small serving fixtures, one per family
  (``tools/serve_expected.py``).
* ``train_expected.json``: the reference package's losses, gradient
  norms, learning rates and parameter slices over 8 train steps of two
  small configs, and one step of every family with its parameters whole
  (``tools/train_expected.py``).
* ``suite_expected.json``, ``service_expected.json``,
  ``frontend_expected.json`` (with the HLO texts under ``hlo/``) and
  ``zoo_expected.json``: the reference package's results that
  ``chip_smoke.py``'s later phases are held to.
"""
from .base import (FULL_ATTENTION_ONLY, HW, SHAPES, ModelConfig, ShapeConfig,
                   TrainConfig, shape_applicable)

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


__all__ = ["ModelConfig", "ShapeConfig", "TrainConfig", "SHAPES", "HW",
           "ARCHS", "get_config", "shape_applicable", "FULL_ATTENTION_ONLY"]
