"""Mixture-of-Experts FFN: sort-based capacity dispatch, a port of the
single-card path of the reference package's ``models/moe.py`` (its
``mesh is None`` branch of ``moe_ffn``).

Every token picks its top-k experts; the (token, expert) pairs are sorted
by expert id (stably: the lower token index keeps the lower position);
each pair's position within its expert is its index in that sorted run,
and positions at or beyond the capacity ``ceil(k * n * capacity_factor /
E)`` are dropped to a dump row at ``E * C``.  The experts run as batched
products over (E, C, d) buffers and the outputs are scatter-added back to
their tokens, weighted by the renormalised gates.

Capacity is per call, over all n tokens of the call, so a token's output
can depend on the other tokens of its batch (in a decode step, on the
other slots, idle ones included).  That is the reference's behaviour and
is kept.  Ties follow the reference: ``jax.lax.top_k`` prefers the lower
expert index (here a stable descending sort) and ``jnp.argsort`` is stable
(here ``stable=True``).

The reference's ``shard_map`` paths (experts tensor-parallel with a
``psum``, or expert-parallel with two all-to-alls) are not ported: the
port runs on one card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(cfg.top_k * n_tokens * cfg.capacity_factor / cfg.n_experts)
    return max(int(c), 1)


def _dispatch(x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig,
              capacity: int):
    """x: (n,d) -> (buf (E,C,d), slot (n*k,), tok (n*k,), gate (n*k,),
    aux), all in the expert-sorted order of the (token, expert) pairs."""
    n, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                   # (n,E)
    vals, order_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[:, :k], order_e[:, :k]                 # (n,k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    # load-balance aux (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(n * k, device=x.device)) / (n * k)
    aux = E * torch.sum(me * ce)

    flat_e = idx.reshape(-1)                                # (n*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    tok = order // k
    first = torch.searchsorted(sorted_e, torch.arange(E, device=x.device),
                               side="left")
    pos = torch.arange(n * k, device=x.device) - first[sorted_e]
    slot = torch.where(pos < capacity, sorted_e * capacity + pos,
                       E * capacity)
    buf = torch.zeros((E * capacity + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x[tok]
    return (buf[:-1].reshape(E, capacity, d), slot, tok,
            gate.reshape(-1)[order], aux)


def _combine(y: torch.Tensor, slot, tok, gate, n: int) -> torch.Tensor:
    """y: (E,C,d) expert outputs -> (n,d) token outputs."""
    d = y.shape[-1]
    flat = torch.cat([y.reshape(-1, d), y.new_zeros((1, d))], dim=0)
    vals = flat[slot] * gate[:, None].to(y.dtype)
    return y.new_zeros((n, d)).index_add_(0, tok, vals)


def _expert_ffn(buf, wg, wu, wd):
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg))
    h = h * torch.einsum("ecd,edf->ecf", buf, wu)
    return torch.einsum("ecf,efd->ecd", h, wd)


def _local_tp(x, router_w, wg, wu, wd, cfg: ModelConfig):
    n = x.shape[0]
    C = _capacity(n, cfg)
    buf, slot, tok, gate, aux = _dispatch(x, router_w, cfg, C)
    y = _expert_ffn(buf, wg.to(x.dtype), wu.to(x.dtype), wd.to(x.dtype))
    return _combine(y, slot, tok, gate, n), aux


def moe_ffn(x: torch.Tensor, wb: dict, cfg: ModelConfig):
    """x: (B,T,d) -> ((B,T,d), aux load-balance loss)."""
    B, T, d = x.shape
    y, aux = _local_tp(x.reshape(-1, d), wb["router"], wb["wg"], wb["wu"],
                       wb["wd"], cfg)
    return y.reshape(B, T, d), aux


def ep_rules(cfg: ModelConfig) -> dict:
    """Sharding-rule override when experts are model-sharded."""
    if cfg.moe_parallelism == "ep":
        return {"expert": ("model",), "mlp": ()}
    return {}
