"""Train-step factory: value-and-grad + grad accumulation + AdamW, the
reference package's ``train/train_loop.py`` on autograd.

The gradient is ``models.module.value_and_grad``: ``torch.autograd.grad``
of the loss over detached copies of the parameters, not a torch.func
transform, whose backward would keep every intermediate alive until the
gradient returns and so cost more memory than the blocks'
rematerialisation (``models/remat.py``) saves.

The step differentiates the reference's own training math: it runs the
model's loss inside ``kernels.ops.differentiable()``, so attention and the
recurrences take their plain versions (``attention_ref``, the chunked
recurrences of ``kernels/ref.py``) on every device, as the reference's
train step does; the forward-only CUDA kernels launch nowhere in it.

One card has no shardings to compile with, so the reference's
``jit_train_step`` is not ported; ``shardings_for_train`` gives the
PartitionSpec trees a multi-device layout would use.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import TrainConfig
from ..kernels import ops
from ..models import ModelApi
from ..models.module import tree_map, value_and_grad
from ..sharding import PartitionSpec, param_partition_specs
from ..sharding.rules import DEFAULT_RULES
from .optimizer import AdamState, adamw_update


def make_train_step(api: ModelApi, tc: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics), with metrics ``loss``, ``grad_norm`` and ``lr`` (0-d
    float32 tensors).

    Grad accumulation: the batch's leading dim is split into
    ``tc.microbatches`` equal chunks, taken in order; their float32
    gradients and losses are summed, then divided by the count.  A batch
    that does not split evenly raises ``ValueError``."""

    def loss_fn(p, b):
        if tc.cast_params_bf16:
            # bf16 compute copy once per step; grads flow back to the f32
            # masters through the cast
            p = tree_map(lambda x: x.to(torch.bfloat16)
                         if x.dtype == torch.float32 and x.ndim > 1 else x, p)
        with ops.differentiable():
            return api.loss_fn(p, b)

    loss_and_grad = value_and_grad(loss_fn)

    def train_step(params, opt_state: AdamState, batch):
        mb = tc.microbatches
        if mb > 1:
            sizes = {x.shape[0] for x in batch.values()}
            if any(n % mb for n in sizes):
                raise ValueError(f"a batch of leading sizes {sorted(sizes)} "
                                 f"does not split into {mb} microbatches")
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = 0.0
            for i in range(mb):
                part = {k: x.reshape(mb, x.shape[0] // mb, *x.shape[1:])[i]
                        for k, x in batch.items()}
                l, g = loss_and_grad(params, part)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / mb, grads)
            loss = loss / mb
        else:
            loss, grads = loss_and_grad(params, batch)
        params, opt_state, metrics = adamw_update(params, grads, opt_state, tc)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def shardings_for_train(api: ModelApi, mesh, rules: Optional[dict] = None):
    """(param_specs, opt_specs, merged rules): PartitionSpec trees of the
    parameters and of the optimizer state (the moments sharded like their
    parameters, the step replicated)."""
    merged = dict(DEFAULT_RULES)
    merged.update(api.rules_override())
    if rules:
        merged.update(rules)
    pspecs = param_partition_specs(api.specs(), mesh, merged)
    opt_specs = AdamState(mu=pspecs, nu=pspecs, step=PartitionSpec())
    return pspecs, opt_specs, merged
