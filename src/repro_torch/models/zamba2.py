"""Zamba2-7B hybrid: 81 Mamba2 blocks and one *shared* attention block
applied every 6 blocks on concat(hidden, original embedding) (2d -> d).

A port of the reference package's ``models/zamba2.py``.  Layout: 13
groups of 6 blocks and a tail of 3; the shared attention block (one set of
weights) fires before each group and before the tail, 14 applications per
forward.  Decode state: 81 Mamba2 states (O(1) in the sequence) and 14 KV
caches for the shared block.  A prompt's shared attention goes through
``kernels.ops.flash_attention`` (the CUDA kernel, K4, on the card), a
decode step's through ``layers.attention_decode``.  ``decode_step``
writes the new key and value into the caches it is given, in place,
where the reference builds new arrays; it returns the same tensors.
Each Mamba2 block is rematerialised when a gradient is taken under
``cfg.remat == "block"`` (``remat.py``), as the reference checkpoints
its block scan's body; the shared attention is not.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from .layers import (WHOLE, attention_decode, compute_dtype, cross_entropy,
                     embed_lookup, rms_norm, rope)
from .module import ParamSpec
from . import mamba2, remat


def _split(cfg: ModelConfig):
    k = cfg.attn_every
    n_full = cfg.n_layers // k
    tail = cfg.n_layers - n_full * k
    return k, n_full, tail


def n_attn_applications(cfg: ModelConfig) -> int:
    k, n_full, tail = _split(cfg)
    return n_full + (1 if tail else 0)


def _grouped(specs: dict, n: int) -> dict:
    return {k: ParamSpec((n,) + s.shape, ("group",) + s.logical,
                         init=s.init, scale=s.scale, dtype=s.dtype)
            for k, s in specs.items()}


def zamba_specs(cfg: ModelConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    V = cfg.padded_vocab()
    k, n_full, tail = _split(cfg)
    shared = {
        "ln": ParamSpec((2 * d,), ("embed",), init="ones"),
        "wq": ParamSpec((2 * d, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((2 * d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((2 * d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed")),
    }
    out = {
        "embed": ParamSpec((V, d), ("vocab", "embed")),
        "shared_attn": shared,
        "groups": _grouped(mamba2.mamba_specs(cfg, k), n_full),
        "ln_f": ParamSpec((d,), ("embed",), init="ones"),
        "lm_head": ParamSpec((d, V), ("embed", "vocab")),
    }
    if tail:
        out["tail"] = mamba2.mamba_specs(cfg, tail)
    return out


def shared_attn(h, x0, w, cfg: ModelConfig, positions, cache=None, cur=None,
                tp=WHOLE):
    """Shared attention on concat(h, x0).  Returns (h + out, kv): for a
    prompt kv = (k, v) of the whole sequence; for a decode step kv = the
    caches (ck, cv) with this step's key and value written at ``cur``.
    ``tp``: the tensor-parallel hooks (``layers.Whole``), over the heads of
    ``w``."""
    x = torch.cat([h, x0], dim=-1)
    x = tp.full(rms_norm(x, w["ln"]))
    q = torch.einsum("btd,dhk->bthk", x, w["wq"].to(x.dtype))
    k = torch.einsum("btd,dgk->btgk", x, w["wk"].to(x.dtype))
    v = torch.einsum("btd,dgk->btgk", x, w["wv"].to(x.dtype))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        o = kops.flash_attention(q, k, v, causal=True,
                                 block_kv=cfg.attn_chunk_kv)
        kv = (k, v)
    else:
        ck, cv = cache
        T = k.shape[1]
        ck[:, cur:cur + T] = k.to(ck.dtype)
        cv[:, cur:cur + T] = v.to(cv.dtype)
        o = attention_decode(q, ck, cv, cur)
        kv = (ck, cv)
    out = tp.row(o, w["wo"], "bthk,hkd->btd")
    return h + out, kv


def _layer(tree: dict, *idx) -> dict:
    out = tree
    for i in idx:
        out = {key: val[i] for key, val in out.items()}
    return out


def _stack(states: list) -> dict:
    return {key: torch.stack([st[key] for st in states]) for key in states[0]}


def forward(params, tokens, cfg: ModelConfig, state=None, kv_caches=None,
            cur_index=None, return_state=False):
    """tokens (B,T) -> logits (B,T,V) float32.  A decode step when
    ``state`` is given: ``kv_caches`` is the (napp, B, S, KV, hd) pair,
    ``cur_index`` the write position.  With ``return_state`` (or in a
    decode step) also returns the Mamba2 state ({"groups", "tail"}) and
    the attention's (group kv, tail kv) for a prompt, or the caches for a
    decode step."""
    B, T = tokens.shape
    k_grp, n_full, tail = _split(cfg)
    h = embed_lookup(params["embed"], tokens, compute_dtype(cfg))
    x0 = h
    dev = h.device
    positions = (torch.arange(T, device=dev) if cur_index is None
                 else torch.full((T,), int(cur_index), device=dev))
    decode = state is not None
    want_state = decode or return_state

    def blk(hh, wb, bst):
        hh, bst = mamba2.block_apply(hh, wb, cfg, bst)
        return hh, (bst if want_state else None)

    def blocks(hh, weights, n, st_of):
        new = []
        for i in range(n):
            bst = (st_of(i) if decode else
                   mamba2.zero_state(cfg, B, hh.dtype, dev))
            hh, bst = remat.block(cfg, blk, hh, _layer(weights, i), bst)
            new.append(bst)
        return hh, (_stack(new) if new and want_state else None)

    kvs, g_states = [], []
    for g in range(n_full):
        kvc = ((kv_caches[0][g], kv_caches[1][g]) if decode else None)
        h, kv = shared_attn(h, x0, params["shared_attn"], cfg, positions,
                            cache=kvc, cur=cur_index)
        h, g_st = blocks(h, _layer(params["groups"], g), k_grp,
                         lambda i: _layer(state["groups"], g, i))
        kvs.append(kv)
        g_states.append(g_st)

    tail_kv, t_state = None, None
    if tail:
        kvc = ((kv_caches[0][n_full], kv_caches[1][n_full]) if decode
               else None)
        h, tail_kv = shared_attn(h, x0, params["shared_attn"], cfg,
                                 positions, cache=kvc, cur=cur_index)
        h, t_state = blocks(h, params["tail"], tail,
                            lambda i: _layer(state["tail"], i))

    h = rms_norm(h, params["ln_f"])
    logits = torch.einsum("btd,dv->btv", h,
                          params["lm_head"].to(h.dtype)).float()
    if not want_state:
        return logits
    mstate = {"groups": _stack(g_states), "tail": t_state}
    if decode:                      # the caches, updated in place
        return logits, mstate, kv_caches
    group_kv = (torch.stack([kv[0] for kv in kvs]),
                torch.stack([kv[1] for kv in kvs]))
    return logits, mstate, (group_kv, tail_kv)


def loss_fn(params, batch, cfg: ModelConfig):
    """Token-mean cross entropy (z-loss 1e-4, optional ``mask``) of the
    teacher-forced forward."""
    logits = forward(params, batch["tokens"], cfg)
    return cross_entropy(logits, batch["labels"], z_loss=1e-4,
                         mask=batch.get("mask"))


# ------------------------------------------------------------------ serving

def state_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    k, n_full, tail = _split(cfg)
    KV, hd = cfg.n_kv_heads, cfg.hd
    napp = n_attn_applications(cfg)
    dt = compute_dtype(cfg)

    def stack(specs, n):
        return {kk: ParamSpec((n,) + s.shape, ("group",) + s.logical,
                              init="zeros", dtype=s.dtype)
                for kk, s in specs.items()}

    out = {
        "mamba": {
            "groups": stack(mamba2.state_specs(cfg, k, batch), n_full),
        },
        "kv": {
            "k": ParamSpec((napp, batch, seq, KV, hd),
                           ("group", "batch", "kv_seq", "kv_heads", "head_dim"),
                           init="zeros", dtype=dt),
            "v": ParamSpec((napp, batch, seq, KV, hd),
                           ("group", "batch", "kv_seq", "kv_heads", "head_dim"),
                           init="zeros", dtype=dt),
        },
    }
    if tail:
        out["mamba"]["tail"] = mamba2.state_specs(cfg, tail, batch)
    return out


def prefill(params, tokens, cfg: ModelConfig, cache_len: int = 0):
    """Returns (last logits, decode state matching ``state_specs``)."""
    B, T = tokens.shape
    S = cache_len or T
    logits, mstate, (kvs, tail_kv) = forward(params, tokens, cfg,
                                             return_state=True)
    KV, hd = cfg.n_kv_heads, cfg.hd
    napp = n_attn_applications(cfg)
    kk, vv = kvs
    if tail_kv is not None:
        kk = torch.cat([kk, tail_kv[0][None]], dim=0)
        vv = torch.cat([vv, tail_kv[1][None]], dim=0)
    dt = compute_dtype(cfg)
    ck = torch.zeros((napp, B, S, KV, hd), dtype=dt, device=logits.device)
    cv = torch.zeros_like(ck)
    ck[:, :, :T] = kk.to(dt)
    cv[:, :, :T] = vv.to(dt)
    if mstate["tail"] is None:
        del mstate["tail"]
    return logits[:, -1], {"mamba": mstate, "kv": {"k": ck, "v": cv}}


def decode_step(params, state, tokens, cur_index, cfg: ModelConfig):
    """One token for every sequence of the batch; the KV caches in
    ``state`` are updated in place."""
    logits, mstate, _ = forward(
        params, tokens, cfg, state=state["mamba"],
        kv_caches=(state["kv"]["k"], state["kv"]["v"]), cur_index=cur_index)
    if mstate["tail"] is None:
        del mstate["tail"]
    return logits[:, 0], {"mamba": mstate, "kv": state["kv"]}
