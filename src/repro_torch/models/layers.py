"""Shared model layers: RMSNorm, RoPE, SwiGLU, the embedding lookup, GQA
attention (the chunked online-softmax reference and the decode path) and
the training loss (``cross_entropy``), as plain PyTorch ops.

They mirror the reference package's ``models/layers.py`` step by step,
dtypes included: RMSNorm in float32, attention scores and outputs
accumulated in float32 (the reference's ``preferred_element_type``), the
probabilities cast to the cache's dtype before the output product.  None
of these is a TPU kernel in the reference, so none is a kernel here;
``scaled_dot_product_attention`` is not used.  The prefill attention of
the models goes through ``kernels.ops.flash_attention``, which runs
``attention_ref`` for tensors on the CPU and the CUDA kernel (K4) on the
card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .remat import checkpoint

_NEG_INF = -1e30


def compute_dtype(cfg) -> torch.dtype:
    """The torch dtype named by ``cfg.dtype`` (``"bfloat16"``, ...)."""
    return getattr(torch, cfg.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """Rotary embedding; x: (..., T, H, hd), positions: (T,) or (..., T)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs                  # (..., T, half)
    cos = torch.cos(ang)[..., None, :]                          # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


class Whole:
    """The tensor-parallel hooks a block calls (``parallel._Plan`` on a
    rank of the sharded train step), for a process that holds all of the
    block: each does nothing beyond the plain op."""

    def full(self, x):
        """A norm's output, for the column-parallel products."""
        return x

    def seq(self, x):
        """This process's sequence block of ``x``."""
        return x

    def cols(self, x):
        """This process's columns (the last dimension) of a leaf as wide
        as the model, for its heads."""
        return x

    def row(self, x, w, eq=None):
        """The row-parallel product of ``x`` and ``w`` (``eq`` for
        ``torch.einsum``, else a matmul), in ``x``'s dtype."""
        w = w.to(x.dtype)
        return x @ w if eq is None else torch.einsum(eq, x, w)

    def norm(self, x, w):
        """``rms_norm`` over the last dimension, whole or split."""
        return rms_norm(x, w)


WHOLE = Whole()


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,T,H,hd), k: (B,C,KV,hd) -> (B,H,T,C) float32, GQA grouping."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, T, KV, G, hd)
    s = torch.einsum("btkgd,bckd->bkgtc", qg.float(), k.float())
    return s.reshape(B, KV * G, T, k.shape[1])


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B,H,T,C) float32, v: (B,C,KV,hd) -> (B,T,H,hd) float32.  p is
    rounded to v's dtype first, then the product accumulates in float32."""
    B, H, T, C = p.shape
    KV = v.shape[2]
    G = H // KV
    pg = p.reshape(B, KV, G, T, C).to(v.dtype)
    o = torch.einsum("bkgtc,bckd->btkgd", pg.float(), v.float())
    return o.reshape(B, T, H, v.shape[3])


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  chunk_kv: int = 1024, q_offset: int = 0):
    """Chunked online-softmax attention.  q: (B,T,H,hd); k,v: (B,S,KV,hd);
    ``q_offset`` is the absolute position of q[0]; ``window`` > 0 keeps
    the last ``window`` positions.  Returns (B,T,H,hd) in q's dtype."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    C = min(chunk_kv, S)
    while S % C:
        C -= 1
    scale = hd ** -0.5
    dev = q.device
    qpos = q_offset + torch.arange(T, device=dev)
    m = torch.full((B, H, T), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, T, hd), dtype=torch.float32, device=dev)

    def body(m, l, acc, q, ks, vs, i):
        s = _gqa_scores(q, ks) * scale                  # (B,H,T,C)
        kpos = i * C + torch.arange(C, device=dev)
        mask = torch.ones((T, C), dtype=torch.bool, device=dev)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window:
            mask &= qpos[:, None] - kpos[None, :] < window
        s = torch.where(mask[None, None], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _gqa_out(p, vs).transpose(1, 2)
        return m_new, l, acc

    # the chunk body is rematerialised, as in the reference: without it the
    # backward keeps every chunk's (B,H,T,C) probabilities
    for i in range(S // C):
        m, l, acc = checkpoint(body, m, l, acc, q, k[:, i * C:(i + 1) * C],
                               v[:, i * C:(i + 1) * C], i)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.transpose(1, 2).to(q.dtype)             # (B,T,H,hd)


def attention_decode(q, k_cache, v_cache, cur_index: int):
    """Single-token decode: q (B,1,H,hd) against the cache (B,S,KV,hd),
    masked to positions <= ``cur_index``."""
    hd = q.shape[-1]
    S = k_cache.shape[1]
    s = _gqa_scores(q, k_cache) * (hd ** -0.5)          # (B,H,1,S)
    mask = torch.arange(S, device=q.device)[None, None, None, :] <= cur_index
    s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _gqa_out(p, v_cache).to(q.dtype)             # (B,1,H,hd)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, dtype):
    """Rows of the embedding table, cast to ``dtype``: the same rows the
    reference's one-hot contraction gives."""
    return embed[tokens].to(dtype)


def cross_entropy(logits, labels, z_loss: float = 0.0, mask=None):
    """Token-mean cross entropy with an optional z-loss, in float32;
    logits (B,T,V), labels (B,T), mask (B,T) or None.  The label logit is
    taken with the reference's compare-and-select reduction (labels ==
    iota, ``where``, sum) rather than a gather, so the traced graph keeps
    the reference's operations."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    V = logits.shape[-1]
    hit = labels[..., None] == torch.arange(V, device=logits.device)
    ll = torch.where(hit, logits, 0.0).sum(dim=-1)
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    if mask is not None:
        return (loss * mask).sum() / torch.clamp_min(mask.sum(), 1)
    return loss.mean()
