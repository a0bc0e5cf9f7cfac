"""Model registry of the port: a uniform functional API over the model
zoo's families, as in the reference package's ``models/__init__.py``.

For every family — ``ssm`` (rwkv6-7b), ``hybrid`` (zamba2-7b), the
transformer families ``dense``, ``moe`` and ``vlm`` (``transformer.py``)
and ``encdec`` (seamless-m4t-large-v2, ``encdec.py``):
  specs()                           -> ParamSpec tree
  init(generator, device)           -> parameters
  abstract()                        -> parameters as ``meta`` tensors
  loss_fn(params, batch)            -> scalar loss        (train shapes)
  prefill_fn(params, batch)         -> (last logits, decode state)
  decode_fn(params, cache, batch)   -> (logits, decode state)
  input_specs(shape)                -> the batch of one shape, as ``meta``
  cache_specs(shape)                -> decode-state ParamSpec tree
  rules_override()                  -> the family's sharding-rule override
A ``vlm`` batch carries ``prefix_embeds`` (B, n_patches, d_model) beside
its ``tokens``, an ``encdec`` batch ``frame_embeds`` (B, enc_len,
d_model).  ``module.logical_axes`` gives the logical-axis tree of
``specs()``; with ``rules_override`` (``moe.ep_rules`` for an MoE) it
feeds ``sharding.rules``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from . import encdec, moe, rwkv6, transformer, zamba2
from .layers import compute_dtype
from .module import abstract_params, init_params, param_count

PORTED = ("ssm", "hybrid", "dense", "moe", "vlm", "encdec")
TRANSFORMER = ("dense", "moe", "vlm")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclass
class ModelApi:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family not in PORTED:
            raise ValueError(f"unknown family {self.cfg.family!r} of "
                             f"{self.cfg.name}")

    def _module(self):
        f = self.cfg.family
        if f in TRANSFORMER:
            return transformer
        return {"ssm": rwkv6, "hybrid": zamba2, "encdec": encdec}[f]

    # ------------------------------------------------------------- params
    def specs(self):
        c = self.cfg
        if c.family in TRANSFORMER:
            return transformer.decoder_specs(c)
        if c.family == "ssm":
            return rwkv6.rwkv_specs(c)
        if c.family == "hybrid":
            return zamba2.zamba_specs(c)
        return encdec.encdec_specs(c)

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None):
        return init_params(self.specs(), generator, device)

    def abstract(self):
        return abstract_params(self.specs())

    def n_params(self) -> int:
        return param_count(self.specs())

    # -------------------------------------------------------------- train
    def loss_fn(self, params, batch):
        return self._module().loss_fn(params, batch, self.cfg)

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
        if c.family == "hybrid":
            return zamba2.prefill(params, batch["tokens"], c,
                                  cache_len=cache_len)
        return encdec.prefill(params, batch["frame_embeds"], batch["tokens"],
                              c, cache_len=cache_len or
                              batch["tokens"].shape[1])

    def decode_fn(self, params, cache, batch):
        tokens, cur = batch["tokens"], batch["cur_index"]
        return self._module().decode_step(params, cache, tokens, cur,
                                          self.cfg)

    # ------------------------------------------------------------- shapes
    def enc_len(self, shape: ShapeConfig) -> int:
        return min(shape.seq_len, self.cfg.enc_len_cap)

    def input_specs(self, shape: ShapeConfig) -> dict:
        """The batch of one shape cell as ``meta`` tensors (int32 tokens
        and labels, embeddings in the compute dtype), as the reference's
        ``input_specs`` gives them as ShapeDtypeStructs.  A decode batch's
        ``cur_index`` is the last position of a ``seq_len`` cache, a
        Python int: the port's ``decode_step`` takes the position as a
        constant, where the reference's is a traced int32 scalar."""
        c = self.cfg
        B, T = shape.global_batch, shape.seq_len
        dt = compute_dtype(c)
        if shape.kind == "decode":
            return {"tokens": _meta((B, 1), torch.int32),
                    "cur_index": T - 1}
        batch = {"tokens": _meta((B, T), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = _meta((B, T), torch.int32)
        if c.family == "encdec":
            batch["frame_embeds"] = _meta((B, self.enc_len(shape), c.d_model),
                                          dt)
        elif c.family == "vlm":
            batch["prefix_embeds"] = _meta((B, c.n_patches, c.d_model), dt)
        return batch

    def cache_specs(self, shape: ShapeConfig):
        c = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if c.family in TRANSFORMER:
            return transformer.cache_specs(c, B, S)
        if c.family == "ssm":
            return rwkv6.state_specs(c, B, S)
        if c.family == "hybrid":
            return zamba2.state_specs(c, B, S)
        return encdec.cache_specs(c, B, S, self.enc_len(shape))

    def rules_override(self) -> dict:
        return moe.ep_rules(self.cfg) if self.cfg.n_experts else {}


def get_model(cfg: ModelConfig) -> ModelApi:
    return ModelApi(cfg)
