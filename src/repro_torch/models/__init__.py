"""Model registry of the port: a uniform functional API over the model
zoo's families, as in the reference package's ``models/__init__.py``.

For the families ported so far — ``ssm`` (rwkv6-7b), ``hybrid``
(zamba2-7b) and the transformer families ``dense``, ``moe`` and ``vlm``
(``transformer.py``):
  specs()                           -> ParamSpec tree
  init(generator, device)           -> parameters
  prefill_fn(params, batch)         -> (last logits, decode state)
  decode_fn(params, cache, batch)   -> (logits, decode state)
  cache_specs(shape)                -> decode-state ParamSpec tree
A ``vlm`` prefill batch carries ``prefix_embeds`` (B, n_patches, d_model)
beside its ``tokens``.  ``get_model`` raises ``NotImplementedError``
naming the roadmap item for ``encdec``; training (``loss_fn``) is not
ported yet either.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from . import rwkv6, transformer, zamba2
from .module import init_params, param_count

PORTED = ("ssm", "hybrid", "dense", "moe", "vlm")
TRANSFORMER = ("dense", "moe", "vlm")


@dataclass
class ModelApi:
    cfg: ModelConfig

    def __post_init__(self):
        c = self.cfg
        if c.family not in PORTED:
            raise NotImplementedError(
                f"the {c.family!r} family of {c.name} is not ported to "
                f"PyTorch yet (ROADMAP A9/A10: encdec is the next slice)")

    # ------------------------------------------------------------- params
    def specs(self):
        if self.cfg.family in TRANSFORMER:
            return transformer.decoder_specs(self.cfg)
        if self.cfg.family == "ssm":
            return rwkv6.rwkv_specs(self.cfg)
        return zamba2.zamba_specs(self.cfg)

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None):
        return init_params(self.specs(), generator, device)

    def n_params(self) -> int:
        return param_count(self.specs())

    # ------------------------------------------------------------ serving
    def prefill_fn(self, params, batch, cache_len: int = 0):
        c = self.cfg
        if c.family in TRANSFORMER:
            return transformer.prefill(
                params, batch["tokens"], c, cache_len=cache_len,
                prefix_embeds=(batch["prefix_embeds"] if c.family == "vlm"
                               else None))
        if c.family == "ssm":
            return rwkv6.prefill(params, batch["tokens"], c)
        return zamba2.prefill(params, batch["tokens"], c, cache_len=cache_len)

    def decode_fn(self, params, cache, batch):
        c = self.cfg
        tokens, cur = batch["tokens"], batch["cur_index"]
        if c.family in TRANSFORMER:
            return transformer.decode_step(params, cache, tokens, cur, c)
        if c.family == "ssm":
            return rwkv6.decode_step(params, cache, tokens, cur, c)
        return zamba2.decode_step(params, cache, tokens, cur, c)

    def cache_specs(self, shape: ShapeConfig):
        c = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if c.family in TRANSFORMER:
            return transformer.cache_specs(c, B, S)
        if c.family == "ssm":
            return rwkv6.state_specs(c, B, S)
        return zamba2.state_specs(c, B, S)


def get_model(cfg: ModelConfig) -> ModelApi:
    return ModelApi(cfg)
