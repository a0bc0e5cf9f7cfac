"""Gradient compression: int8 quantized all-reduce with error feedback,
the reference package's ``train/compression.py`` over
``torch.distributed``.

Compressing the data-parallel gradient reduction 4x (f32 -> int8 +
per-tensor scale) cuts its bytes term; error feedback keeps convergence
(the quantization residual is carried into the next step).

Usage: in a data-parallel train step (``make_dp_train_step``) each rank's
local, unreduced gradients go through ``compressed_psum_local`` instead of
a plain all-reduce.  ``group`` is a ``torch.distributed`` process group
(the default group when one is initialised); with none initialised the
world is this one rank and nothing is communicated.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.module import tree_leaves, tree_map, value_and_grad


def _world(group) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    if _world(group) > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


def quantize_int8(x):
    """Per-tensor symmetric int8.  Returns (q, scale)."""
    x = x.to(torch.float32)
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum_local(grads, err, group=None):
    """Quantize this rank's gradients (+error feedback) against a scale
    shared by a MAX all-reduce, sum the int8 payload over the ranks (as
    int32 — no overflow for <=2^23 ranks), and return (mean f32 grads in
    each gradient's dtype, new error residuals)."""
    n = _world(group)

    def one(g, e):
        target = g.to(torch.float32) + e
        s_shared = _all_reduce(
            torch.clamp(target.abs().max(), min=1e-12) / 127.0,
            dist.ReduceOp.MAX, group)
        q = torch.clamp(torch.round(target / s_shared), -127, 127)
        recon = q * s_shared
        tot = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
        return (tot.to(torch.float32) * s_shared / n).to(g.dtype), \
            target - recon

    out = tree_map(one, grads, err)
    return (tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out))


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def make_dp_train_step(loss_fn, update_fn, group=None,
                       compress: bool = True):
    """Data-parallel train step with an explicit (optionally compressed)
    gradient all-reduce.  Each rank calls it with its own shard of the
    batch and the same replicated params, optimizer state and error
    residuals.

    loss_fn(params, batch)->scalar; update_fn(params, grads, opt)->(p,opt).
    Returns step(params, opt, err, batch)->(params, opt, err, loss), the
    loss averaged over the ranks."""
    loss_and_grad = value_and_grad(loss_fn)

    def step(params, opt, err, batch):
        loss, grads = loss_and_grad(params, batch)
        n = _world(group)
        loss = _all_reduce(loss.detach().clone(), dist.ReduceOp.SUM,
                           group) / n
        if compress:
            grads, err = compressed_psum_local(grads, err, group)
        else:
            for g in tree_leaves(grads):
                _all_reduce(g, dist.ReduceOp.SUM, group)
            grads = tree_map(lambda g: g / n, grads)
        params, opt = update_fn(params, grads, opt)
        return params, opt, err, loss

    return step
