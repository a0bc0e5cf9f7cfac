"""Encoder-decoder transformer backbone (SeamlessM4T-large v2), a port of
the reference package's ``models/encdec.py``.

The speech frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings (B, Te, d).  The encoder runs bidirectional
pre-LN blocks; the decoder causal self-attention, cross-attention over the
encoder's frames (no RoPE on the encoder's memory) and a SwiGLU FFN.  The
decode state is the decoder's self-attention KV cache and the cross K/V of
the encoder's frames, computed once at prefill.

Every attention over a whole sequence goes through
``kernels.ops.flash_attention`` with the config's ``attn_chunk_kv``: the
encoder's (non-causal), the decoder's (causal) and the cross-attention
(non-causal, T decoder tokens over S = Te frames).  On the card that is
the CUDA kernel (K4), three launches per layer pair per prefill; on the
CPU or ``meta`` the plain ``attention_ref``.  A decode step attends
through ``layers.attention_decode``.

Where the reference's ``prefill`` computes the cross K/V twice (inside the
decoder stack and again for the cache), the port keeps the stack's: the
values are the same.  ``decode_step`` writes each layer's new key and
value into the cache it is given, in place, as ``transformer.py`` does.
Layers run in a Python loop where the reference scans; each encoder and
decoder block is rematerialised when a gradient is taken under
``cfg.remat == "block"`` (``remat.py``), as the reference checkpoints its
scan bodies.  Its sharding constraints are dropped (one card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from .layers import (WHOLE, attention_decode, compute_dtype, cross_entropy,
                     embed_lookup, rms_norm, rope)
from .module import ParamSpec
from . import remat


# ------------------------------------------------------------------- specs

def _attn_specs(lay, d, H, KV, hd, prefix=""):
    return {
        prefix + "ln": lay((d,), ("embed",), init="ones"),
        prefix + "wq": lay((d, H, hd), ("embed", "heads", "head_dim")),
        prefix + "wk": lay((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        prefix + "wv": lay((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        prefix + "wo": lay((H, hd, d), ("heads", "head_dim", "embed")),
    }


def _ffn_specs(lay, d, ff):
    return {
        "ln2": lay((d,), ("embed",), init="ones"),
        "wg": lay((d, ff), ("embed", "mlp")),
        "wu": lay((d, ff), ("embed", "mlp")),
        "wd": lay((ff, d), ("mlp", "embed")),
    }


def encdec_specs(cfg: ModelConfig) -> dict:
    d, H, KV, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)
    V = cfg.padded_vocab()
    Le, Ld = cfg.n_enc_layers, cfg.n_layers

    def laye(shape, logical, **kw):
        return ParamSpec((Le,) + shape, ("layers",) + logical, **kw)

    def layd(shape, logical, **kw):
        return ParamSpec((Ld,) + shape, ("layers",) + logical, **kw)

    enc = {**_attn_specs(laye, d, H, KV, hd), **_ffn_specs(laye, d, ff)}
    dec = {**_attn_specs(layd, d, H, KV, hd),
           **_attn_specs(layd, d, H, KV, hd, prefix="x_"),
           **_ffn_specs(layd, d, ff)}
    return {
        "embed": ParamSpec((V, d), ("vocab", "embed")),
        "enc_blocks": enc,
        "dec_blocks": dec,
        "enc_ln_f": ParamSpec((d,), ("embed",), init="ones"),
        "ln_f": ParamSpec((d,), ("embed",), init="ones"),
        "lm_head": ParamSpec((d, V), ("embed", "vocab")),
    }


# ----------------------------------------------------------------- forward

def _layer(blocks: dict, i: int) -> dict:
    return {key: val[i] for key, val in blocks.items()}


def _ffn(h, wb, tp=WHOLE):
    x = tp.full(rms_norm(h, wb["ln2"]))
    wg, wu, wd = (wb[k].to(x.dtype) for k in ("wg", "wu", "wd"))
    return h + tp.row(F.silu(x @ wg) * (x @ wu), wd)


def _self_attn(x, wb, cfg: ModelConfig, positions, causal: bool, tp=WHOLE):
    """Self-attention of a whole sequence from position 0 over the heads
    of ``wb``; returns (out, (k, v))."""
    q = torch.einsum("btd,dhk->bthk", x, wb["wq"].to(x.dtype))
    k = torch.einsum("btd,dgk->btgk", x, wb["wk"].to(x.dtype))
    v = torch.einsum("btd,dgk->btgk", x, wb["wv"].to(x.dtype))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = kops.flash_attention(q, k, v, causal=causal,
                             block_kv=cfg.attn_chunk_kv)
    return tp.row(o, wb["wo"], "bthk,hkd->btd"), (k, v)


def encoder_block(h, wb, cfg: ModelConfig, positions, tp=WHOLE):
    """One bidirectional encoder block over the frames; returns (h, (k,
    v)).  ``tp``: the tensor-parallel hooks (``layers.Whole``)."""
    o, kv = _self_attn(tp.full(rms_norm(h, wb["ln"])), wb, cfg, positions,
                       False, tp)
    return _ffn(h + o, wb, tp), kv


def encode(params, frame_embeds, cfg: ModelConfig):
    """frame_embeds: (B, Te, d) from the (stubbed) modality frontend ->
    the encoder's output (B, Te, d) in the compute dtype."""
    h = frame_embeds.to(compute_dtype(cfg))
    positions = torch.arange(h.shape[1], device=h.device)

    def body(hh, wb):
        return encoder_block(hh, wb, cfg, positions)[0]

    for i in range(cfg.n_enc_layers):
        h = remat.block(cfg, body, h, _layer(params["enc_blocks"], i))
    return rms_norm(h, params["enc_ln_f"])


def _cross_kv(enc_out, wb):
    k = torch.einsum("btd,dgk->btgk", enc_out, wb["x_wk"].to(enc_out.dtype))
    v = torch.einsum("btd,dgk->btgk", enc_out, wb["x_wv"].to(enc_out.dtype))
    return k, v


def decoder_block(h, wb, enc_out, cfg: ModelConfig, positions, tp=WHOLE):
    """One decoder block over the whole target sequence: causal
    self-attention, cross-attention over ``enc_out`` (no RoPE on the
    encoder's memory) and the FFN.  Returns (h, (k, v), (xk, xv)).
    ``tp``: the tensor-parallel hooks (``layers.Whole``)."""
    o, kv = _self_attn(tp.full(rms_norm(h, wb["ln"])), wb, cfg, positions,
                       True, tp)
    h = h + o
    x = tp.full(rms_norm(h, wb["x_ln"]))
    q = torch.einsum("btd,dhk->bthk", x, wb["x_wq"].to(x.dtype))
    xk, xv = _cross_kv(enc_out, wb)
    o = kops.flash_attention(q, xk, xv, causal=False,
                             block_kv=cfg.attn_chunk_kv)
    h = _ffn(h + tp.row(o, wb["x_wo"], "bthk,hkd->btd"), wb, tp)
    return h, kv, (xk, xv)


def decode_stack(params, tokens, enc_out, cfg: ModelConfig,
                 return_cache: bool = False):
    """Teacher-forced decoder over the whole target sequence.  Returns
    logits (B,T,V) float32, or with ``return_cache`` (logits, (k, v),
    (xk, xv)): the self-attention keys and values (L,B,T,KV,hd) and the
    cross K/V of the encoder's frames (L,B,Te,KV,hd)."""
    h = embed_lookup(params["embed"], tokens, compute_dtype(cfg))
    positions = torch.arange(h.shape[1], device=h.device)

    def body(hh, wb, enc):
        hh, kv, xkv = decoder_block(hh, wb, enc, cfg, positions)
        return (hh, kv, xkv) if return_cache else (hh, None, None)

    ks, vs, xks, xvs = [], [], [], []
    for i in range(cfg.n_layers):
        h, kv, xkv = remat.block(cfg, body, h,
                                 _layer(params["dec_blocks"], i), enc_out)
        if return_cache:
            ks.append(kv[0])
            vs.append(kv[1])
            xks.append(xkv[0])
            xvs.append(xkv[1])
    h = rms_norm(h, params["ln_f"])
    logits = torch.einsum("btd,dv->btv", h,
                          params["lm_head"].to(h.dtype)).float()
    if return_cache:
        return (logits, (torch.stack(ks), torch.stack(vs)),
                (torch.stack(xks), torch.stack(xvs)))
    return logits


def forward(params, batch, cfg: ModelConfig):
    enc_out = encode(params, batch["frame_embeds"], cfg)
    return decode_stack(params, batch["tokens"], enc_out, cfg)


def loss_fn(params, batch, cfg: ModelConfig):
    """Token-mean cross entropy (z-loss 1e-4, optional ``mask``) of the
    teacher-forced forward."""
    return cross_entropy(forward(params, batch, cfg), batch["labels"],
                         z_loss=1e-4, mask=batch.get("mask"))


# ------------------------------------------------------------------ serving

def cache_specs(cfg: ModelConfig, batch: int, seq: int, enc_len: int) -> dict:
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    dt = compute_dtype(cfg)
    kv = ParamSpec((L, batch, seq, KV, hd),
                   ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                   init="zeros", dtype=dt)
    xkv = ParamSpec((L, batch, enc_len, KV, hd),
                    ("layers", "batch", "enc_seq", "kv_heads", "head_dim"),
                    init="zeros", dtype=dt)
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}


def prefill(params, frame_embeds, tokens, cfg: ModelConfig, cache_len: int):
    """Encode, run the teacher-forced prompt and build the decode state:
    returns (last-token logits, {"k", "v": (L,B,cache_len,KV,hd), "xk",
    "xv": (L,B,Te,KV,hd)})."""
    T = tokens.shape[1]
    if cache_len < T:
        raise ValueError(f"cache_len={cache_len} is shorter than the "
                         f"prompt's {T} tokens")
    enc_out = encode(params, frame_embeds, cfg)
    logits, (k, v), (xk, xv) = decode_stack(params, tokens, enc_out, cfg,
                                            return_cache=True)
    dt = compute_dtype(cfg)
    pad = (0, 0, 0, 0, 0, cache_len - T)
    return logits[:, -1], {
        "k": torch.nn.functional.pad(k.to(dt), pad),
        "v": torch.nn.functional.pad(v.to(dt), pad),
        "xk": xk.to(dt), "xv": xv.to(dt)}


def decode_step(params, cache, tokens, cur_index: int, cfg: ModelConfig):
    """One decoder token for every sequence of the batch at absolute
    position ``cur_index``; tokens (B,1).  Returns (logits (B,V), cache),
    the self-attention cache written in place."""
    cur = int(cur_index)
    h = embed_lookup(params["embed"], tokens, compute_dtype(cfg))
    ck_all, cv_all, xk_all, xv_all = (cache["k"], cache["v"], cache["xk"],
                                      cache["xv"])
    # the reference's dynamic_update_slice clamps the start into the cache
    write_pos = min(cur, ck_all.shape[2] - 1)
    positions = torch.full((1,), cur, device=h.device)
    for li in range(cfg.n_layers):
        wb = _layer(params["dec_blocks"], li)
        x = rms_norm(h, wb["ln"])
        q = torch.einsum("btd,dhk->bthk", x, wb["wq"].to(x.dtype))
        k = torch.einsum("btd,dgk->btgk", x, wb["wk"].to(x.dtype))
        v = torch.einsum("btd,dgk->btgk", x, wb["wv"].to(x.dtype))
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        ck_all[li, :, write_pos] = k[:, 0].to(ck_all.dtype)
        cv_all[li, :, write_pos] = v[:, 0].to(cv_all.dtype)
        o = attention_decode(q, ck_all[li], cv_all[li], cur)
        h = h + torch.einsum("bthk,hkd->btd", o, wb["wo"].to(h.dtype))
        x = rms_norm(h, wb["x_ln"])
        q = torch.einsum("btd,dhk->bthk", x, wb["x_wq"].to(x.dtype))
        o = attention_decode(q, xk_all[li], xv_all[li],
                             xk_all.shape[2] - 1)
        h = _ffn(h + torch.einsum("bthk,hkd->btd", o, wb["x_wo"].to(h.dtype)),
                 wb)
    h = rms_norm(h, params["ln_f"])
    logits = (h[:, 0] @ params["lm_head"].to(h.dtype)).float()
    return logits, {**cache, "k": ck_all, "v": cv_all}
