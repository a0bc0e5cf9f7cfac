"""Collectives over a ``launch.mesh.RankMesh``'s process groups, the port's
counterparts of the ``jax.lax`` collectives inside the reference's
``shard_map`` bodies, with the gradients ``shard_map`` gives them under
``check_vma=False``.

* ``psum`` (``jax.lax.psum``): ``all_reduce``; its transpose is ``psum``.
* ``pmean``: ``psum`` over the group's size.
* ``all_to_all`` (``jax.lax.all_to_all`` with ``split_axis == concat_axis
  == 0``): ``all_to_all_single``; its transpose is itself.
* ``psum_scatter`` (``tiled=True``): ``reduce_scatter_tensor`` along a
  dimension; its transpose is the ``all_gather`` of that dimension.
* ``all_gather`` (``tiled=True``): ``all_gather_into_tensor`` along a
  dimension; its transpose is the ``psum_scatter`` of that dimension.
* ``pmax``: the largest value over the group (``all_reduce`` with
  ``MAX``), no gradient (the log-sum-exp's shift).
* ``agree``: the group's first rank's value on every rank
  (``broadcast``); its gradient is the identity, since the ranks held the
  same value to rounding.

The sharded train step keeps ``shard_map``'s convention through the whole
step: a value replicated over some ranks carries on each of them a part
of its cotangent, the parts summing to the whole.  ``gather_param`` is
its FSDP gather of one parameter: the all-gather of the dimensions its
spec shards over the axes being gathered, whose transpose reduce-scatters
the gradient back into the shard (summed over those ranks: the
data-parallel reduction), and the sum of the gradient over every axis
the spec does not name (``sum_unnamed``: a leaf replicated over
``model``, such as a norm, has a partial gradient on each ``model``
rank).  Sums of low-precision cotangents are taken in float32.

The reference's ``shard_map`` takes global arrays and returns them; the
port's ranks each hold the global tensors, so two more functions stand for
its edges, with the transposes of ``shard_map``'s own (``_shard_map_
transpose``): ``shard`` slices a rank's block out of a global input (with
``agree``, the first of the ranks that share the block broadcasts it), and
its gradient is summed over every rank (the ``psum`` over the axes the
input's spec does not name, then the blocks of the axes it does);
``assemble`` gathers the blocks of a global output, and its gradient is
the rank's block of the output's gradient over the size of the axes the
output's spec does not name.

Every call is counted in ``COUNTS`` (calls and payload bytes by label:
the ``torch.distributed`` call's name, ``gather_params:<axes>`` for the
all-gathers of the FSDP gathers, by the axes gathered, or ``shard`` and
``assemble`` for the edges).  The names used exist in torch 2.11 and
2.13 (2.13 calls ``reduce_scatter_tensor`` and ``all_gather_into_tensor``
deprecated).
``gloo`` takes CUDA tensors for all four collectives in torch 2.11
(``chip_smoke.py`` phase "moe"), so nothing is staged through host memory
here (gloo's own CUDA path copies through it).
"""
from __future__ import annotations

import math
import warnings
from typing import Dict, Sequence

import torch
import torch.distributed as dist

#: calls and payload bytes by label since ``reset_counts``
COUNTS: Dict[str, list] = {}


def reset_counts() -> None:
    COUNTS.clear()


def _run(label: str, call, out: torch.Tensor,
         inp: torch.Tensor) -> torch.Tensor:
    """``call(out, inp)``, counted under ``label``."""
    c = COUNTS.setdefault(label, [0, 0])
    c[0] += 1
    c[1] += inp.numel() * inp.element_size()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=FutureWarning,
                                message=".*is deprecated.*")
        call(out, inp)
    return out


def _all_reduce(x: torch.Tensor, group, label="all_reduce",
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    return _run(label, lambda o, _: dist.all_reduce(o, op=op, group=group),
                out, out)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    return _run("all_to_all_single",
                lambda o, i: dist.all_to_all_single(o, i, group=group),
                torch.empty_like(x), x)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    _run("reduce_scatter_tensor",
         lambda o, i: dist.reduce_scatter_tensor(o, i, group=group), out, x)
    return out.movedim(0, dim)


def _all_gather(x: torch.Tensor, group, dim: int,
                label="all_gather_into_tensor") -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] * n,) + tuple(x.shape[1:]))
    _run(label, lambda o, i: dist.all_gather_into_tensor(o, i, group=group),
         out, x)
    return out.movedim(0, dim)


def _sum_dtype(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a dtype to sum over ranks in: float32 for a narrower
    floating dtype."""
    if x.is_floating_point() and x.element_size() < 4:
        return x.float()
    return x


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_to_all(ct, ctx.group), None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, ct):
        return _all_gather(ct, ctx.group, ctx.dim), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, ct):
        return (_reduce_scatter(_sum_dtype(ct), ctx.group, ctx.dim)
                .to(ct.dtype), None, None)


class _Agree(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        out = x.contiguous().clone()
        return _run("broadcast", lambda o, _: dist.broadcast(
            o, src=src, group=group), out, out)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return _Psum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return _Psum.apply(x, group) / dist.get_world_size(group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of ``x``'s first dimension goes to the group's rank i; the
    result's chunk j came from rank j."""
    return _AllToAll.apply(x, group)


def psum_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the group, of which this rank keeps chunk (its group
    rank) of dimension ``dim``."""
    return _PsumScatter.apply(x, group, dim)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` along ``dim``, in group-rank order."""
    return _AllGather.apply(x, group, dim)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise largest value over the group; no gradient."""
    return _all_reduce(x.detach(), group, op=dist.ReduceOp.MAX)


def agree(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The value of ``x`` on the first of the ranks that differ from this
    one only on ``axes``, on all of them (nothing when they are one)."""
    if math.prod(mesh.shape[a] for a in axes) == 1:
        return x
    group, ranks = mesh.group(axes)
    return _Agree.apply(x, group, ranks[0])


# ------------------------------------------------------------ FSDP gathers

def sum_unnamed(g: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """A parameter's gradient summed over ``axes``, the mesh axes its spec
    does not name: the ranks along them hold the same parameter and each
    a part of its gradient."""
    axes = [a for a in axes if mesh.shape[a] > 1]
    if not axes:
        return g
    return _all_reduce(g, mesh.group(axes)[0])


def _gather_plan(p: torch.Tensor, spec: Sequence, mesh,
                 keep: Sequence[str]) -> tuple:
    """((dim, group) of each dimension to gather, the axes ``spec`` does
    not name) of one parameter block (``gather_param``)."""
    from .rules import spec_axes
    axes_per_dim = spec_axes(spec, p.ndim)
    plan = []
    for dim, axes in enumerate(axes_per_dim):
        gathered = tuple(a for a in axes if a not in keep)
        if not gathered:
            continue
        if len(gathered) != len(axes):
            raise ValueError(f"dimension {dim} of spec {tuple(spec)} mixes "
                             f"kept axes {tuple(keep)} with gathered ones")
        if list(axes) != [a for a in mesh.axis_names if a in axes]:
            raise ValueError(f"spec {tuple(spec)} names {axes} out of the "
                             f"mesh's order {mesh.axis_names}")
        if math.prod(mesh.shape[a] for a in axes) > 1:
            plan.append((dim, axes))
    named = {a for axes in axes_per_dim for a in axes}
    return tuple(plan), tuple(a for a in mesh.axis_names if a not in named)


class _GatherParams(torch.autograd.Function):
    """The FSDP gather of several parameter blocks at once: per bucket of
    blocks that gather one dimension over the same ranks in the same
    dtype, one all-gather of their flattened blocks side by side; per set
    of unnamed axes, one all-reduce of the gradients side by side."""

    @staticmethod
    def forward(ctx, meta, *ps):
        plans, dtypes, mesh = meta
        ctx.meta, ctx.masters = meta, [p.dtype for p in ps]
        xs = [p.to(dt) if dt is not None else p for p, dt in zip(ps, dtypes)]
        out = list(xs)
        for (axes, dtype), idx in _buckets(plans, xs).items():
            group = mesh.group(axes)[0]
            rows = [xs[i].movedim(plans[i][0][0][0], 0) for i in idx]
            flat = torch.cat([r.reshape(1, -1) for r in rows], dim=1)
            got = _all_gather(flat, group, 0, _gather_label(axes))
            off = 0
            for i, r in zip(idx, rows):
                piece = got[:, off:off + r.numel()]
                off += r.numel()
                full = piece.reshape(-1, *r.shape[1:])
                out[i] = full.movedim(0, plans[i][0][0][0])
        return tuple(out)

    @staticmethod
    def backward(ctx, *cts):
        plans, dtypes, mesh = ctx.meta
        gs = [_sum_dtype(ct.to(m) if m.is_floating_point else ct)
              for ct, m in zip(cts, ctx.masters)]
        for (axes, _), idx in _buckets(plans, gs).items():
            group, ranks = mesh.group(axes)
            n = len(ranks)
            rows = [gs[i].movedim(plans[i][0][0][0], 0) for i in idx]
            flat = torch.cat([r.reshape(n, -1) for r in rows], dim=1)
            mine = _reduce_scatter(flat, group, 0)
            off = 0
            for i, r in zip(idx, rows):
                k = r.numel() // n
                blk = mine[:, off:off + k].reshape(r.shape[0] // n,
                                                   *r.shape[1:])
                off += k
                gs[i] = blk.movedim(0, plans[i][0][0][0])
        by_axes = {}
        for i, (_, unnamed) in enumerate(plans):
            by_axes.setdefault((unnamed, gs[i].dtype), []).append(i)
        for (unnamed, _), idx in by_axes.items():
            flat = torch.cat([gs[i].reshape(-1) for i in idx])
            flat = sum_unnamed(flat, mesh, unnamed)
            off = 0
            for i in idx:
                gs[i] = flat[off:off + gs[i].numel()].reshape(gs[i].shape)
                off += gs[i].numel()
        return (None,) + tuple(g.to(m) for g, m in zip(gs, ctx.masters))


def _gather_label(axes) -> str:
    """``COUNTS``' label of an FSDP gather over ``axes``."""
    return "gather_params:" + "+".join(axes)


def _buckets(plans, xs) -> dict:
    """{(gathered axes, dtype): indices of the blocks that gather one
    dimension over them}."""
    out = {}
    for i, (plan, _) in enumerate(plans):
        if plan:
            out.setdefault((plan[0][1], xs[i].dtype), []).append(i)
    return out


def gather_params(ps: dict, specs: dict, mesh,
                  keep: Sequence[str] = ("model",),
                  dtypes: dict = None) -> dict:
    """The FSDP gather of parameter blocks ``ps`` laid out by ``specs``
    (both keyed alike): every dimension sharded over axes outside
    ``keep`` all-gathered over them (``keep=()``: the whole parameter),
    each block cast to ``dtypes[key]`` first (a bf16 compute copy moves 2
    bytes per element).  The gradient is reduce-scattered back into each
    block and summed over the axes its spec does not name
    (``sum_unnamed``), in float32 or the block's dtype.  Blocks that
    gather one dimension over the same ranks in the same dtype share one
    all-gather and one reduce-scatter.  A block that gathers two
    dimensions is gathered by itself (``gather_param``).  A dimension
    that mixes a kept axis with a gathered one, or names its axes out of
    the mesh's order, raises ``ValueError``."""
    dtypes = dtypes or {}
    keys, plans, out = [], [], {}
    for k, p in ps.items():
        plan = _gather_plan(p, specs[k], mesh, keep)
        if len(plan[0]) > 1:
            out[k] = gather_param(p, specs[k], mesh, keep, dtypes.get(k))
        else:
            keys.append(k)
            plans.append(plan)
    if keys:
        got = _GatherParams.apply(
            (tuple(plans), tuple(dtypes.get(k) for k in keys), mesh),
            *(ps[k] for k in keys))
        out.update(zip(keys, got))
    return {k: out[k] for k in ps}


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, plan, unnamed, mesh, dtype):
        ctx.plan, ctx.unnamed, ctx.mesh, ctx.dtype = plan, unnamed, mesh, \
            p.dtype
        x = p.to(dtype) if dtype is not None else p
        for dim, axes in plan:
            x = _all_gather(x, mesh.group(axes)[0], dim, _gather_label(axes))
        return x

    @staticmethod
    def backward(ctx, ct):
        g = ct.to(ctx.dtype) if ctx.dtype.is_floating_point else ct
        g = _sum_dtype(g)
        for dim, axes in reversed(ctx.plan):
            g = _reduce_scatter(g, ctx.mesh.group(axes)[0], dim)
        return (sum_unnamed(g, ctx.mesh, ctx.unnamed).to(ctx.dtype), None,
                None, None, None)


def gather_param(p: torch.Tensor, spec: Sequence, mesh,
                 keep: Sequence[str] = ("model",),
                 dtype: torch.dtype = None) -> torch.Tensor:
    """``gather_params`` of one block."""
    plan, unnamed = _gather_plan(p, spec, mesh, keep)
    return _GatherParam.apply(p, plan, unnamed, mesh, dtype)


# ------------------------------------------------------ the shard_map edges

def _block(shape, spec: Sequence, mesh, coords) -> tuple:
    """The slices of the block at ``coords`` of a global ``shape`` under
    ``spec`` (per dimension: a tuple of mesh axes, major first, or ()),
    ``rules.NamedSharding``'s."""
    from .rules import NamedSharding
    return NamedSharding(mesh, spec).index(shape, coords)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh, agree):
        ctx.shape, ctx.index = x.shape, _block(x.shape, spec, mesh,
                                               mesh.coords)
        ctx.world = mesh.group(mesh.axis_names)[0]
        block = x[ctx.index].contiguous().clone()
        sharing = [a for a in mesh.axis_names
                   if not any(a in ax for ax in spec)]
        if agree and math.prod(mesh.shape[a] for a in sharing) > 1:
            group, ranks = mesh.group(sharing)
            _run("broadcast", lambda o, _: dist.broadcast(
                o, src=ranks[0], group=group), block, block)
        return block

    @staticmethod
    def backward(ctx, ct):
        full = ct.new_zeros(ctx.shape)
        full[ctx.index] = ct
        return _all_reduce(full, ctx.world, "shard"), None, None, None


class _Assemble(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape, spec, mesh):
        named = [a for a in mesh.axis_names if any(a in ax for ax in spec)]
        ctx.index = _block(shape, spec, mesh, mesh.coords)
        ctx.scale = math.prod(mesh.shape[a] for a in mesh.axis_names
                              if a not in named)
        if math.prod(mesh.shape[a] for a in named) == 1:
            return x.reshape(shape).clone()
        group, ranks = mesh.group(named)
        blocks = _all_gather(x.reshape(1, -1), group, 0,
                             "assemble").chunk(len(ranks), 0)
        out = x.new_empty(shape)
        for r, b in zip(ranks, blocks):
            out[_block(shape, spec, mesh, mesh.coords_of(r))] = \
                b.reshape(x.shape)
        return out

    @staticmethod
    def backward(ctx, ct):
        return ct[ctx.index] / ctx.scale, None, None, None


def shard(x: torch.Tensor, spec: Sequence, mesh,
          agree: bool = False) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``spec``.  With
    ``agree`` the ranks that hold the same block take the first one's
    (``broadcast``): a value each rank computed for itself, such as an
    activation, can differ between ranks in its last bits (CUDA's
    ``index_add_`` adds in no fixed order), and ranks whose partial sums
    are added slot by slot must route the same tokens."""
    return _Shard.apply(x, tuple(tuple(a) for a in spec), mesh, agree)


def assemble(x: torch.Tensor, shape, spec: Sequence, mesh) -> torch.Tensor:
    """The global tensor of ``shape`` whose blocks under ``spec`` are the
    ranks' ``x``."""
    return _Assemble.apply(x, tuple(shape), tuple(tuple(a) for a in spec),
                           mesh)
