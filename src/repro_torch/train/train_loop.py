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

``jit_train_step`` is the reference's sharded step on a (data, model)
mesh of ``torch.distributed`` ranks (``launch.mesh.RankMesh``): each rank
holds its shards of the parameters and AdamW moments, as the
``PartitionSpec`` trees of ``shardings_for_train`` place them
(``sharding.rules.named_sharding``), and its rows of the global batch
(``rank_rows``).  The loss and its gradient are ``models/parallel.py``'s
(FSDP over ``data``, tensor parallelism over ``model`` for the
transformer families, the generic path for the others); the gradients
come back already reduced into each rank's shards; the global norm sums
each element once (a leaf replicated over an axis counts on the axis's
first rank only) and AdamW updates the shards.  ``shard_tree`` and
``assemble_tree`` cut a full tree into a rank's shards and put the full
tree back together from them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..configs.base import TrainConfig
from ..kernels import ops
from ..models import ModelApi, parallel
from ..models.module import (tree_leaves, tree_leaves_sorted, tree_map,
                             value_and_grad)
from ..sharding import PartitionSpec, param_partition_specs
from ..sharding import collectives as coll
from ..sharding.rules import DEFAULT_RULES, named_sharding, spec_axes
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
        loss, grads = _accumulate(loss_and_grad, params, batch,
                                  tc.microbatches)
        params, opt_state, metrics = adamw_update(params, grads, opt_state, tc)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _accumulate(loss_and_grad, params, batch, mb: int):
    """(loss, float32 grads) of ``batch`` split into ``mb`` equal
    microbatches in order: their sums divided by ``mb``."""
    if mb <= 1:
        return loss_and_grad(params, batch)
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
    return loss / mb, tree_map(lambda g: g / mb, grads)


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


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts and ``AdamState``s whose
    ``specs`` tree has a ``PartitionSpec`` at each leaf."""
    if _is_spec(specs):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, AdamState):
        return AdamState(*(_map_specs(fn, getattr(tree, f),
                                      getattr(specs, f))
                           for f in AdamState._fields))
    raise TypeError(f"no spec for a {type(tree).__name__}")


def flatten_specs(specs, path: tuple = ()) -> dict:
    """{checkpoint key: spec} of a specs tree (dicts, ``AdamState``s,
    ``PartitionSpec`` leaves), in ``checkpoint._flatten``'s order and
    spelling."""
    if _is_spec(specs):
        return {"/".join(path) or "root": specs}
    if isinstance(specs, AdamState):
        items = [("." + f, getattr(specs, f)) for f in AdamState._fields]
    else:
        items = [(str(k), specs[k]) for k in sorted(specs)]
    return {k: v for name, sub in items
            for k, v in flatten_specs(sub, path + (name,)).items()}


def shard_tree(tree, specs, mesh):
    """This rank's blocks (copies) of a full tree of tensors, laid out by
    the parallel ``specs`` tree (``shardings_for_train``'s)."""
    return _map_specs(lambda x, s: named_sharding(mesh, s).block(x).clone(),
                      tree, specs)


def assemble_tree(tree, specs, mesh, dst: int = 0):
    """The full tree from every rank's blocks, in host memory on rank
    ``dst``; the other ranks get a tree of None.  A collective: every rank
    calls it.  Counted in ``collectives.COUNTS`` as ``assemble``."""
    import torch.distributed as dist
    from ..sharding.rules import NamedSharding
    world = mesh.group(mesh.axis_names)[0]
    here = mesh.rank == dst

    def one(x, spec):
        x = x.detach().cpu().contiguous()
        shape = tuple(n * math.prod(mesh.shape[a] for a in axes)
                      for n, axes in zip(x.shape, spec_axes(spec, x.ndim)))
        blocks = [torch.empty_like(x) for _ in range(mesh.size)] \
            if here else None
        coll._run("assemble", lambda o, i: dist.gather(
            i, o, dst=dst, group=world), blocks, x)
        if not here:
            return None
        out = x.new_empty(shape)
        for r, b in enumerate(blocks):
            out[NamedSharding(mesh, spec).index(shape, mesh.coords_of(r))] = b
        return out
    return _map_specs(one, tree, specs)


def _sumsq(g, spec, mesh) -> torch.Tensor:
    """A shard's float32 sum of squares, zero on a rank off coordinate 0
    of an axis ``spec`` does not name (an element replicated over an axis
    counts once)."""
    named = {a for axes in spec_axes(spec, g.ndim) for a in axes}
    part = torch.sum(torch.square(g.to(torch.float32)))
    if any(mesh.coords[a] for a in mesh.axis_names if a not in named):
        part = torch.zeros_like(part)
    return part


def sharded_global_norm(grads, pspecs, mesh) -> torch.Tensor:
    """``optimizer.global_norm`` of the full gradients from this rank's
    shards: each leaf's ``_sumsq``, in the reference's leaf order, summed
    over every rank."""
    total = None
    for g, spec in zip(tree_leaves_sorted(grads),
                       tree_leaves_sorted(pspecs)):
        part = _sumsq(g, spec, mesh)
        total = part if total is None else total + part
    if mesh.size > 1:
        total = coll._all_reduce(total, mesh.group(mesh.axis_names)[0])
    return torch.sqrt(total)


def leaf_norms(grads, pspecs=None, mesh=None) -> dict:
    """{checkpoint key: the float32 norm of the full leaf} of a gradient
    tree; with ``pspecs`` and ``mesh``, of the full gradients from this
    rank's shards (each leaf's ``_sumsq``, one all-reduce)."""
    from .checkpoint import _flatten
    flat = _flatten(grads)
    if mesh is None:
        sq = [torch.sum(torch.square(g.to(torch.float32)))
              for g in flat.values()]
    else:
        specs = flatten_specs(pspecs)
        sq = [_sumsq(g, specs[k], mesh) for k, g in flat.items()]
    sq = torch.stack(sq)
    if mesh is not None and mesh.size > 1:
        sq = coll._all_reduce(sq, mesh.group(mesh.axis_names)[0])
    return dict(zip(flat, torch.sqrt(sq).tolist()))


def jit_train_step(api: ModelApi, tc: TrainConfig, mesh, rules=None,
                   donate: bool = True):
    """The sharded train step on this rank of ``mesh``, a
    ``launch.mesh.RankMesh`` (a ``Mesh`` with no ranks behind it raises
    ``TypeError``): returns ``(step, pspecs, opt_specs, merged)`` as the
    reference's does.  ``step(params, opt_state, batch)`` takes this
    rank's shards of the parameters and moments (``shard_tree`` of
    ``pspecs`` and ``opt_specs``) and its rows of the global batch
    (``batch[k][parallel.rank_rows(B, mesh, tc.microbatches)]``) and
    returns the new shards and the metrics ``loss``, ``grad_norm`` and
    ``lr``: the global values, equal on every rank.  ``step.path`` names
    the model's path (``parallel.path_for``); ``step.grads(params,
    batch)`` is the step's (loss, gradient shards) without the update.  ``donate`` is accepted for
    the reference's signature; the step builds new tensors, as
    ``make_train_step`` does.

    Microbatches split this rank's rows in order (``rank_rows`` puts
    each microbatch's block there) and their float32 gradients are summed
    and divided by the count, as ``make_train_step`` does.  With
    ``cast_params_bf16`` each shard is cast before its gather, which then
    moves 2 bytes per parameter."""
    from ..launch.mesh import RankMesh
    if not isinstance(mesh, RankMesh):
        raise TypeError(f"jit_train_step needs a RankMesh (ranks of a "
                        f"torch.distributed world), got "
                        f"{type(mesh).__name__}")
    pspecs, opt_specs, merged = shardings_for_train(api, mesh, rules)
    path = parallel.path_for(api.cfg, mesh, pspecs)
    cast = torch.bfloat16 if tc.cast_params_bf16 else None
    seed = 1.0 / mesh.size

    def loss_and_grad(params, batch):
        with torch.enable_grad():
            q = tree_map(lambda x: x.detach().requires_grad_(), params)
            with ops.differentiable():
                loss = parallel.loss_fn(api, q, batch, mesh, pspecs, cast)
            grads = iter(torch.autograd.grad(
                loss, tree_leaves(q), torch.full_like(loss, seed),
                materialize_grads=True))
        return loss.detach(), tree_map(lambda _: next(grads), params)

    def step(params, opt_state: AdamState, batch):
        loss, grads = _accumulate(loss_and_grad, params, batch,
                                  tc.microbatches)
        gn = sharded_global_norm(grads, pspecs, mesh)
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  tc, grad_norm=gn)
        metrics["loss"] = loss
        return params, opt_state, metrics

    step.path = path
    step.grads = lambda params, batch: _accumulate(
        loss_and_grad, params, batch, tc.microbatches)
    return step, pspecs, opt_specs, merged
