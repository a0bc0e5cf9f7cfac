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
the ``torch.distributed`` call's name, or ``shard`` and ``assemble`` for
the edges).  The names used exist in torch 2.11 and 2.13 (2.13 calls
``reduce_scatter_tensor`` and ``all_gather_into_tensor`` deprecated).
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


def _all_reduce(x: torch.Tensor, group, label="all_reduce") -> torch.Tensor:
    out = x.contiguous().clone()
    return _run(label, lambda o, _: dist.all_reduce(o, group=group), out,
                out)


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


# ------------------------------------------------------ the shard_map edges

def _block(shape, spec: Sequence, mesh, coords) -> tuple:
    """The slices of the block at ``coords`` of a global ``shape`` under
    ``spec`` (per dimension: a tuple of mesh axes, major first, or ())."""
    out = []
    for n, axes in zip(shape, spec):
        k = math.prod(mesh.shape[a] for a in axes)
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + coords[a]
        out.append(slice(i * n // k, (i + 1) * n // k))
    return tuple(out) + (slice(None),) * (len(shape) - len(out))


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
