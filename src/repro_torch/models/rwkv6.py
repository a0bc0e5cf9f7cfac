"""RWKV-6 (Finch): attention-free time mixing with data-dependent decay.

A port of the reference package's ``models/rwkv6.py``: token-shift
lerps, LoRA-parameterised decay w = exp(-exp(w0 + tanh(x@Aw)@Bw)), a
per-head bonus u, the grouped head norm, and the squared-ReLU channel mix
with a receptance gate.  The WKV recurrence runs through ``kernels.ops.wkv6``
(the CUDA kernel on the card, the plain chunked form on the CPU).  The
decode state is O(1) in the sequence: the token-shift prevs and one K x V
matrix per head.

Parameters and state keep the reference's keys and stacked (L, ...)
layouts; layers run in a Python loop where the reference scans, each
block rematerialised when a gradient is taken under ``cfg.remat ==
"block"`` (``remat.py``), as the reference checkpoints its scan body.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from .layers import (WHOLE, compute_dtype, cross_entropy, embed_lookup,
                     rms_norm)
from .module import ParamSpec
from . import remat

_LORA = 64


def rwkv_specs(cfg: ModelConfig) -> dict:
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, hd = cfg.n_heads, cfg.hd
    V = cfg.padded_vocab()

    def lay(shape, logical, **kw):
        return ParamSpec((L,) + shape, ("layers",) + logical, **kw)

    blocks = {
        "ln1": lay((d,), ("embed",), init="ones"),
        "ln2": lay((d,), ("embed",), init="ones"),
        "mu_r": lay((d,), ("embed",), init="zeros"),
        "mu_k": lay((d,), ("embed",), init="zeros"),
        "mu_v": lay((d,), ("embed",), init="zeros"),
        "mu_g": lay((d,), ("embed",), init="zeros"),
        "mu_w": lay((d,), ("embed",), init="zeros"),
        "w0": lay((d,), ("embed",), init="zeros"),
        "Aw": lay((d, _LORA), ("embed", "lora")),
        "Bw": lay((_LORA, d), ("lora", "embed")),
        "Wr": lay((d, H, hd), ("embed", "heads", "head_dim")),
        "Wk": lay((d, H, hd), ("embed", "heads", "head_dim")),
        "Wv": lay((d, H, hd), ("embed", "heads", "head_dim")),
        "Wg": lay((d, H, hd), ("embed", "heads", "head_dim")),
        "Wo": lay((H, hd, d), ("heads", "head_dim", "embed")),
        "u": lay((H, hd), ("heads", "head_dim"), init="zeros"),
        "ln_x": lay((H, hd), ("heads", "head_dim"), init="ones"),
        "mu_ck": lay((d,), ("embed",), init="zeros"),
        "mu_cr": lay((d,), ("embed",), init="zeros"),
        "Wck": lay((d, ff), ("embed", "mlp")),
        "Wcv": lay((ff, d), ("mlp", "embed")),
        "Wcr": lay((d, d), ("embed", None)),
    }
    return {
        "embed": ParamSpec((V, d), ("vocab", "embed")),
        "blocks": blocks,
        "ln_f": ParamSpec((d,), ("embed",), init="ones"),
        "lm_head": ParamSpec((d, V), ("embed", "vocab")),
    }


def _lerp(x, xprev, mu):
    return x + (xprev - x) * mu.to(x.dtype)


def _shift(x, prev):
    """xprev_t = x_{t-1}; prev: (B,d) carried state (zeros at t=0)."""
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def time_mix(h, wb, cfg: ModelConfig, prev, S, tp=WHOLE):
    """h: (B,T,d); prev: (B,d); S: (B,H,hd,hd) -> (out, new_prev, new_S).
    ``tp``: the tensor-parallel hooks (``layers.Whole``); the heads are
    those of ``wb`` (a rank's: its columns of ``w0`` and ``Bw``)."""
    x = tp.full(rms_norm(h, wb["ln1"]))
    B, T, d = x.shape
    H, hd = wb["Wr"].shape[1], cfg.hd
    xp = _shift(x, prev)
    xr, xk, xv, xg, xw = (_lerp(x, xp, wb[m])
                          for m in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"))
    wlog = tp.cols(wb["w0"]).float() + \
        torch.tanh(xw.float() @ wb["Aw"]) @ tp.cols(wb["Bw"])
    w = torch.exp(-torch.exp(wlog))                       # (B,T,H*hd), (0,1)
    dt = x.dtype
    r = torch.einsum("btd,dhk->bhtk", xr, wb["Wr"].to(dt))
    k = torch.einsum("btd,dhk->bhtk", xk, wb["Wk"].to(dt))
    v = torch.einsum("btd,dhk->bhtk", xv, wb["Wv"].to(dt))
    g = F.silu(torch.einsum("btd,dhk->bthk", xg, wb["Wg"].to(dt)))
    wh = w.reshape(B, T, H, hd).transpose(1, 2)           # (B,H,T,hd)
    y, S = kops.wkv6(r.float(), k.float(), v.float(), wh.float(),
                     wb["u"].float(), S, chunk=cfg.ssm_chunk)
    y = y.transpose(1, 2)                                 # (B,T,H,hd)
    y = rms_norm(y, torch.ones((hd,), dtype=torch.float32, device=y.device)) \
        * wb["ln_x"].to(y.dtype)
    y = y * g.to(y.dtype)
    out = tp.row(y.to(h.dtype), wb["Wo"], "bthk,hkd->btd")
    return out, x[:, -1, :], S


def channel_mix(h, wb, cfg: ModelConfig, prev, tp=WHOLE):
    x = tp.full(rms_norm(h, wb["ln2"]))
    xp = _shift(x, prev)
    xk = _lerp(x, xp, wb["mu_ck"])
    xr = _lerp(x, xp, wb["mu_cr"])
    kk = torch.square(torch.relu(xk @ wb["Wck"].to(x.dtype)))
    out = torch.sigmoid(tp.seq(xr) @ wb["Wcr"].to(x.dtype)) * \
        tp.row(kk, wb["Wcv"])
    return out, x[:, -1, :]


def block_apply(h, wb, cfg: ModelConfig, state, tp=WHOLE):
    att, p1, S = time_mix(h, wb, cfg, state["prev_att"], state["S"], tp)
    h = h + att
    ffn, p2 = channel_mix(h, wb, cfg, state["prev_ffn"], tp)
    h = h + ffn
    return h, {"prev_att": p1, "prev_ffn": p2, "S": S}


def _zero_state(cfg: ModelConfig, B: int, dtype, device):
    H, hd = cfg.n_heads, cfg.hd
    return {"prev_att": torch.zeros((B, cfg.d_model), dtype=dtype,
                                    device=device),
            "prev_ffn": torch.zeros((B, cfg.d_model), dtype=dtype,
                                    device=device),
            "S": torch.zeros((B, H, hd, hd), dtype=torch.float32,
                             device=device)}


def forward(params, tokens, cfg: ModelConfig, state=None,
            return_state=False):
    """tokens (B,T) -> logits (B,T,V) float32.  ``state``: the stacked
    per-layer decode state (``state_specs``' layout) or None for zeros."""
    B, T = tokens.shape
    h = embed_lookup(params["embed"], tokens, compute_dtype(cfg))
    blocks = params["blocks"]
    keep = return_state or state is not None

    def body(hh, wb, st):
        if st is None:
            st = _zero_state(cfg, B, hh.dtype, hh.device)
        hh, st = block_apply(hh, wb, cfg, st)
        return hh, (st if keep else None)

    new = []
    for i in range(cfg.n_layers):
        wb = {key: val[i] for key, val in blocks.items()}
        st = (None if state is None
              else {key: val[i] for key, val in state.items()})
        h, st = remat.block(cfg, body, h, wb, st)
        new.append(st)
    h = rms_norm(h, params["ln_f"])
    logits = torch.einsum("btd,dv->btv", h,
                          params["lm_head"].to(h.dtype)).float()
    if return_state:
        return logits, {key: torch.stack([st[key] for st in new])
                        for key in new[0]}
    return logits


def loss_fn(params, batch, cfg: ModelConfig):
    """Token-mean cross entropy (z-loss 1e-4, optional ``mask``) of the
    teacher-forced forward."""
    logits = forward(params, batch["tokens"], cfg)
    return cross_entropy(logits, batch["labels"], z_loss=1e-4,
                         mask=batch.get("mask"))


def state_specs(cfg: ModelConfig, batch: int, seq: int = 0) -> dict:
    L, d, H, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd
    dt = compute_dtype(cfg)
    return {
        "prev_att": ParamSpec((L, batch, d), ("layers", "batch", "embed"),
                              init="zeros", dtype=dt),
        "prev_ffn": ParamSpec((L, batch, d), ("layers", "batch", "embed"),
                              init="zeros", dtype=dt),
        "S": ParamSpec((L, batch, H, hd, hd),
                       ("layers", "batch", "heads", "head_dim", None),
                       init="zeros", dtype=torch.float32),
    }


def prefill(params, tokens, cfg: ModelConfig):
    logits, state = forward(params, tokens, cfg, return_state=True)
    return logits[:, -1], state


def decode_step(params, state, tokens, cur_index, cfg: ModelConfig):
    logits, state = forward(params, tokens, cfg, state=state,
                            return_state=True)
    return logits[:, 0], state
