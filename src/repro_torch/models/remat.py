"""Rematerialisation, the reference package's ``jax.checkpoint``: a
function's activations are not kept for the backward pass; the backward
runs the function again from its inputs and differentiates that run.

``checkpoint(fn, *args)`` is ``fn(*args)`` when no gradient is taken (no
tensor among ``args`` requires one, or grad mode is off): prefill and
decode run the plain call, with nothing recomputed.  When a gradient is
taken, ``fn`` runs inside a ``torch.autograd.Function`` that saves only
its tensor inputs; its backward recomputes ``fn`` and takes the
vector-Jacobian product by plain autograd, nested too (the attention's
chunk body inside a block).  Gradients are taken by plain autograd
(``module.value_and_grad``), not under a torch.func transform, which
rejects the backward's ``requires_grad_``.  ``block(cfg, fn, *args)``
applies it when ``cfg.remat == "block"``, as each family's train forward
wraps its blocks.

``args`` may be nested tuples, lists and dicts; tensors among them are the
function's inputs, everything else is passed through.  ``fn`` must not
read a tensor that needs a gradient from its closure: such a tensor
would get none.  Outputs may nest too; their non-tensor leaves (a dense
block's ``aux`` of 0.0) are returned as they were.
"""
from __future__ import annotations

from contextlib import nullcontext

import torch
from torch.utils import _pytree as pytree

from ..kernels import ops


class _Remat(torch.autograd.Function):
    @staticmethod
    def forward(run, plain_route, *xs):
        return run(*xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, plain_route, *xs = inputs
        ctx.run = run
        ctx.plain_route = plain_route
        ctx.save_for_backward(*xs)

    @staticmethod
    def backward(ctx, *gouts):
        xs = list(ctx.saved_tensors)
        diff = [i for i, x in enumerate(xs)
                if ctx.needs_input_grad[2 + i] and x.is_floating_point()]
        route = ops.differentiable() if ctx.plain_route else nullcontext()
        with route:
            gs = _vjp(ctx.run, xs, diff, gouts) if diff else ()
        grads = [None] * len(xs)
        for i, g in zip(diff, gs):
            grads[i] = g
        return (None, None, *grads)


def _vjp(run, xs, diff, gouts) -> tuple:
    """The recompute's vector-Jacobian product by plain autograd."""
    xs = list(xs)
    for i in diff:
        xs[i] = xs[i].detach().requires_grad_()
    with torch.enable_grad():
        outs = run(*xs)
    pairs = [(o, g) for o, g in zip(outs, gouts)
             if o.is_floating_point() and o.requires_grad]
    if not pairs:
        return tuple(torch.zeros_like(xs[i]) for i in diff)
    return torch.autograd.grad([o for o, _ in pairs], [xs[i] for i in diff],
                               [g for _, g in pairs], materialize_grads=True)


_TENSOR = object()


def checkpoint(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward when a
    gradient is taken (module docstring)."""
    leaves, spec = pytree.tree_flatten(args)
    pos = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    if not (torch.is_grad_enabled() and
            any(leaves[i].requires_grad for i in pos)):
        return fn(*args)
    out_layout = {}

    def run(*xs):
        lv = list(leaves)
        for i, x in zip(pos, xs):
            lv[i] = x
        out = fn(*pytree.tree_unflatten(lv, spec))
        ol, ospec = pytree.tree_flatten(out)
        out_layout["spec"] = ospec
        out_layout["leaves"] = [_TENSOR if isinstance(x, torch.Tensor)
                                else x for x in ol]
        return tuple(x for x in ol if isinstance(x, torch.Tensor))

    outs = iter(_Remat.apply(run, ops.training_route(),
                             *(leaves[i] for i in pos)))
    ol = [next(outs) if x is _TENSOR else x for x in out_layout["leaves"]]
    return pytree.tree_unflatten(ol, out_layout["spec"])


def block(cfg, fn, *args):
    """One model block: ``checkpoint(fn, *args)`` under ``cfg.remat ==
    "block"`` (the default, as in the reference), else ``fn(*args)``."""
    if cfg.remat == "block":
        return checkpoint(fn, *args)
    return fn(*args)
