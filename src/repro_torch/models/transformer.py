"""Decoder-only transformer stack (dense, MoE FFN, VLM prefix): GQA, RoPE
and SwiGLU over stacked per-layer weights, a port of the reference
package's ``models/transformer.py`` for serving.

Covers deepseek-67b, deepseek-coder-33b (heads padded to ``head_pad_to``),
qwen3-0.6b (``qk_norm``), phi3-mini-3.8b, internvl2-2b (a patch-embedding
prefix that replaces the first P token embeddings), mixtral-8x7b (sliding
window and MoE) and granite-moe-1b-a400m (MoE).

The prefill attention (``block_apply``) goes through
``kernels.ops.flash_attention``: the CUDA kernel (K4) on the card,
``layers.attention_ref`` on the CPU.  Decode attends through
``layers.attention_decode``.  ``loss_fn`` differentiates through the
plain path (``ops`` raises for a CUDA call that autograd would
differentiate: the kernels have no backward).  Each block is
rematerialised when a gradient is taken under ``cfg.remat == "block"``
(``remat.py``), as the reference's ``jax.checkpoint`` of its scan body.
The reference's sharding constraints and ``pin_weight_shards`` are hints
to XLA's partitioner and are dropped: on the ranks of a
``launch.mesh.RankMesh`` the sharded train step runs these blocks'
tensor-parallel form (``parallel.py``), with explicit collectives.

``prefill`` raises on a VLM prompt shorter than its prefix: the
reference's ``forward`` then runs over the P prefix positions and none of
the prompt's tokens, and its engine decodes from the prompt's length,
over a prefix position.  ``decode_step`` writes each layer's new key and
value into the stacked cache it is given, in place, where the reference
builds a new array; it returns the same tensors.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from .layers import (attention_decode, compute_dtype, cross_entropy,
                     embed_lookup, rms_norm, rope, swiglu)
from .module import ParamSpec
from . import moe as moe_mod
from . import remat


# ------------------------------------------------------------------- specs

def decoder_specs(cfg: ModelConfig) -> dict:
    L, d = cfg.n_layers, cfg.d_model
    Hp, KV, hd, ff = cfg.padded_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    V = cfg.padded_vocab()

    def lay(shape, logical, **kw):
        return ParamSpec((L,) + shape, ("layers",) + logical, **kw)

    blocks = {
        "ln1": lay((d,), ("embed",), init="ones"),
        "wq": lay((d, Hp, hd), ("embed", "heads", "head_dim")),
        "wk": lay((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": lay((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": lay((Hp, hd, d), ("heads", "head_dim", "embed")),
        "ln2": lay((d,), ("embed",), init="ones"),
    }
    if cfg.qk_norm:
        blocks["qnorm"] = lay((hd,), ("head_dim",), init="ones")
        blocks["knorm"] = lay((hd,), ("head_dim",), init="ones")
    if cfg.n_experts:
        blocks.update({
            "router": lay((d, cfg.n_experts), ("embed", None)),
            "wg": lay((cfg.n_experts, d, ff), ("expert", "embed", "mlp")),
            "wu": lay((cfg.n_experts, d, ff), ("expert", "embed", "mlp")),
            "wd": lay((cfg.n_experts, ff, d), ("expert", "mlp", "embed")),
        })
    else:
        blocks.update({
            "wg": lay((d, ff), ("embed", "mlp")),
            "wu": lay((d, ff), ("embed", "mlp")),
            "wd": lay((ff, d), ("mlp", "embed")),
        })
    return {
        "embed": ParamSpec((V, d), ("vocab", "embed"), scale=1.0),
        "blocks": blocks,
        "ln_f": ParamSpec((d,), ("embed",), init="ones"),
        "lm_head": ParamSpec((d, V), ("embed", "vocab")),
    }


# ----------------------------------------------------------------- forward

def _layer(blocks: dict, i: int) -> dict:
    return {key: val[i] for key, val in blocks.items()}


def _attn_proj(x, wb, cfg: ModelConfig, positions):
    q = torch.einsum("btd,dhk->bthk", x, wb["wq"].to(x.dtype))
    k = torch.einsum("btd,dgk->btgk", x, wb["wk"].to(x.dtype))
    v = torch.einsum("btd,dgk->btgk", x, wb["wv"].to(x.dtype))
    if cfg.qk_norm:
        q = rms_norm(q, wb["qnorm"])
        k = rms_norm(k, wb["knorm"])
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _ffn(x, wb, cfg: ModelConfig):
    if cfg.n_experts:
        return moe_mod.moe_ffn(x, wb, cfg)
    return swiglu(x, wb["wg"].to(x.dtype), wb["wu"].to(x.dtype),
                  wb["wd"].to(x.dtype)), 0.0


def block_apply(h, wb, cfg: ModelConfig, positions):
    """One decoder block over a whole sequence from position 0; h: (B,T,d).
    Returns (h, (k, v), aux)."""
    x = rms_norm(h, wb["ln1"])
    q, k, v = _attn_proj(x, wb, cfg, positions)
    o = kops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                             block_kv=cfg.attn_chunk_kv)
    h = h + torch.einsum("bthk,hkd->btd", o, wb["wo"].to(o.dtype))
    y, aux = _ffn(rms_norm(h, wb["ln2"]), wb, cfg)
    return h + y, (k, v), aux


def embed_tokens(params, tokens, cfg: ModelConfig):
    return embed_lookup(params["embed"], tokens, compute_dtype(cfg))


def forward(params, tokens, cfg: ModelConfig, prefix_embeds=None,
            return_cache: bool = False):
    """Full-sequence forward.  tokens: (B,T); prefix_embeds: (B,P,d), the
    VLM patch prefix, replaces the first P token embeddings (P <= T, else
    ``ValueError``).  Returns (logits (B,T,V) float32, aux), or with
    ``return_cache`` (logits, (k, v) stacked (L,B,T,KV,hd), aux)."""
    h = embed_tokens(params, tokens, cfg)
    if prefix_embeds is not None:
        P = prefix_embeds.shape[1]
        if tokens.shape[1] < P:
            raise ValueError(f"a prompt of {tokens.shape[1]} tokens is "
                             f"shorter than its prefix of {P} patch "
                             f"positions; the prompt must start with P "
                             f"placeholder tokens")
        h = torch.cat([prefix_embeds.to(h.dtype), h[:, P:]], dim=1)
    T = h.shape[1]
    positions = torch.arange(T, device=h.device)

    def body(hh, wb):
        hh, kv, aux = block_apply(hh, wb, cfg, positions)
        return hh, (kv if return_cache else None), aux

    ks, vs, auxes = [], [], []
    for li in range(cfg.n_layers):
        h, kv, aux = remat.block(cfg, body, h, _layer(params["blocks"], li))
        auxes.append(aux)
        if return_cache:
            ks.append(kv[0])
            vs.append(kv[1])
    h = rms_norm(h, params["ln_f"])
    logits = torch.einsum("btd,dv->btv", h,
                          params["lm_head"].to(h.dtype)).float()
    aux_loss = sum(auxes) if cfg.n_experts else 0.0
    if return_cache:
        return logits, (torch.stack(ks), torch.stack(vs)), aux_loss
    return logits, aux_loss


def loss_fn(params, batch, cfg: ModelConfig):
    """Token-mean cross entropy (z-loss 1e-4, optional ``mask``) of the
    teacher-forced forward, plus the MoE load-balancing term
    ``0.01 * aux / n_layers``."""
    logits, aux = forward(params, batch["tokens"], cfg,
                          prefix_embeds=batch.get("prefix_embeds"))
    loss = cross_entropy(logits, batch["labels"], z_loss=1e-4,
                         mask=batch.get("mask"))
    if cfg.n_experts:
        loss = loss + 0.01 * aux / cfg.n_layers
    return loss


# ------------------------------------------------------------------ decode

def cache_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    S = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    sp = ParamSpec((L, batch, S, KV, hd),
                   ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                   init="zeros", dtype=compute_dtype(cfg))
    return {"k": sp, "v": sp}


def prefill(params, tokens, cfg: ModelConfig, prefix_embeds=None,
            cache_len: int = 0):
    """Run the whole prompt; return (last-token logits, stacked KV cache).

    The cache is padded to ``cache_len`` (or the window W) so that
    ``decode_step`` writes in bounds; a sliding-window cache keeps the last
    W positions, rotated so that slot == position % W."""
    logits, (k, v), _ = forward(params, tokens, cfg,
                                prefix_embeds=prefix_embeds,
                                return_cache=True)
    T = tokens.shape[1]
    W = cfg.sliding_window
    if W and W < T:
        k = torch.roll(k[:, :, -W:], T % W, dims=2)
        v = torch.roll(v[:, :, -W:], T % W, dims=2)
    S = min(cache_len, W) if W else cache_len
    if S and S > k.shape[2]:
        pad = (0, 0, 0, 0, 0, S - k.shape[2])
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    return logits[:, -1], {"k": k, "v": v}


def decode_step(params, cache, tokens, cur_index: int, cfg: ModelConfig):
    """One token for every sequence of the batch at absolute position
    ``cur_index``; tokens (B,1).  Returns (logits (B,V), cache), the
    cache's tensors written in place."""
    cur = int(cur_index)
    h = embed_tokens(params, tokens, cfg)
    ck_all, cv_all = cache["k"], cache["v"]
    S = ck_all.shape[2]
    W = cfg.sliding_window
    # the reference's dynamic_update_slice clamps the start into the cache
    write_pos = min(cur % W if (W and W <= S) else cur, S - 1)
    positions = torch.full((1,), cur, device=h.device)
    for li in range(cfg.n_layers):
        wb = _layer(params["blocks"], li)
        q, k, v = _attn_proj(rms_norm(h, wb["ln1"]), wb, cfg, positions)
        ck_all[li, :, write_pos] = k[:, 0].to(ck_all.dtype)
        cv_all[li, :, write_pos] = v[:, 0].to(cv_all.dtype)
        # a rolling (window) cache: slots <= cur are valid until the first
        # wrap, then every slot is
        o = attention_decode(q, ck_all[li], cv_all[li], min(cur, S - 1))
        h = h + torch.einsum("bthk,hkd->btd", o, wb["wo"].to(o.dtype))
        y, _ = _ffn(rms_norm(h, wb["ln2"]), wb, cfg)
        h = h + y
    h = rms_norm(h, params["ln_f"])
    logits = (h[:, 0] @ params["lm_head"].to(h.dtype)).float()
    return logits, {"k": ck_all, "v": cv_all}
