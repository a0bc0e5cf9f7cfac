"""AdamW + cosine schedule + global-norm clipping over trees of tensors,
the reference package's ``train/optimizer.py`` in the same float32
arithmetic and order: the clip scale, the bias corrections, weight decay
on the float32 master, the cast back to the parameter's dtype, and the
global norm summed over the leaves in the reference's order (dict keys
sorted at every level).  Only the per-leaf reduction is torch's own: a
leaf's sum of squares cannot be made bitwise equal to XLA's, so the two
packages' norms agree to rounding.  No torch optimizer class: the update
is a pure function of (params, grads, state).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..configs.base import TrainConfig
from ..models.module import tree_leaves, tree_leaves_sorted, tree_map


class AdamState(NamedTuple):
    mu: object
    nu: object
    step: torch.Tensor          # int32 scalar on the parameters' device


def adamw_init(params) -> AdamState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return AdamState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                     step=torch.zeros((), dtype=torch.int32, device=device))


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def cosine_lr(tc: TrainConfig, step) -> torch.Tensor:
    """Linear warm-up to ``tc.lr`` over ``warmup_steps``, then a cosine
    decay to 0 at ``total_steps``; ``step`` an int or an int tensor."""
    s = _f32(step)
    warm = torch.clamp(s / max(tc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - tc.warmup_steps) /
                       max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    return tc.lr * warm * (0.5 * (1 + torch.cos(math.pi * prog)))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, added in
    the reference's leaf order (``tree_leaves_sorted``)."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves_sorted(tree)))


def adamw_update(params, grads, state: AdamState, tc: TrainConfig,
                 grad_norm=None):
    """Returns (new_params, new_state, metrics).  ``grad_norm`` is the
    gradients' global norm when they are one rank's shards of it (the
    sharded step's), else it is ``global_norm(grads)``."""
    step = state.step + 1
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = (torch.clamp(tc.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
             if tc.grad_clip else 1.0)
    lr = cosine_lr(tc, step)
    b1, b2, eps = tc.beta1, tc.beta2, 1e-8
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, sf)
    bc2 = 1 - torch.pow(b2, sf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / bc1
        vh = v / bc2
        step_ = mh / (torch.sqrt(vh) + eps) + \
            tc.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step_).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)
    pick = lambda i: tree_map(lambda t: t[i], out)          # noqa: E731
    metrics = {"grad_norm": gn, "lr": lr}
    return pick(0), AdamState(mu=pick(1), nu=pick(2), step=step), metrics
