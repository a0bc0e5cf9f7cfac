"""Mixture-of-Experts FFN: sort-based capacity dispatch, a port of the
reference package's ``models/moe.py``.

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

Under ``sharding_ctx`` with a ``launch.mesh.RankMesh`` (ranks of a
``torch.distributed`` world, process groups behind its axes), each rank
runs the reference's ``shard_map`` body on its block and the same
collectives on the mesh's groups (``sharding.collectives``), with the
reference's conditions:

* ``"tp"`` (``_local_tp``): ``x`` split over the batch axes, ``wg``/``wu``
  on their last and ``wd`` on its middle dimension over ``model``; one
  ``psum`` of the (E, C, d) expert outputs over ``model``, or, with
  ``moe_scatter_out`` and ``T % model == 0``, a ``psum_scatter`` of the
  combined output along the sequence;
* ``"ep"`` (``_local_ep``), when ``n_experts % model == 0`` and ``T %
  model == 0``: ``x`` split over the batch axes and, over ``model``, by
  sequence, the experts split over ``model``; two ``all_to_all``s of the
  (A, E/A, C, d) slot blocks, with the reference's ``swapaxes``;
* the aux loss ``pmean``-ed over every axis.

Capacity is per rank's block of tokens, as in the reference, so "tp" with
``data > 1`` and "ep" drop differently from one rank.  A rank's partial
sum of the experts' down projection is kept in float32 through the sum
over ranks and rounded once to the compute dtype: the reference sums bf16
partials, which at granite-moe-1b-a400m's full width put a block up to
1.7e-2 of its magnitude away from one rank's (PERF.md §6); in
float32, as the CPU tests run, the two are the same.  In "tp" the ranks
that share a block of ``x`` take the first one's (a ``broadcast``): each
computed the replicated layers before it itself, where CUDA's
``index_add_`` adds in no fixed order, and inputs that differ in their
last bits can route different tokens, which the sum of slot buffers over
ranks cannot take (PERF.md §6).  The result is the
global (B, T, d) output, assembled from the blocks of the reference's
``out_specs``; gradients are the reference's under ``check_vma=False``
(``sharding.collectives``).  A mesh without groups (``launch.mesh.Mesh``,
the dry-run's production meshes) runs the single-rank path.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..launch.mesh import RankMesh
from ..sharding import collectives as coll
from ..sharding.rules import batch_axes_for, current_mesh


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


def _expert_ffn(buf, wg, wu, wd, out_dtype=None):
    """The experts' SwiGLU; ``out_dtype`` is the down projection's (a rank's
    partial sum over its slice of the hidden dimension is kept in float32
    for the sum over ranks)."""
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg))
    h = h * torch.einsum("ecd,edf->ecf", buf, wu)
    if out_dtype is not None:
        h, wd = h.to(out_dtype), wd.to(out_dtype)
    return torch.einsum("ecf,efd->ecd", h, wd)


def _local_tp(x, router_w, wg, wu, wd, cfg: ModelConfig, group=None,
              world=None, defer_psum: bool = False):
    n = x.shape[0]
    C = _capacity(n, cfg)
    buf, slot, tok, gate, aux = _dispatch(x, router_w, cfg, C)
    y = _expert_ffn(buf, wg.to(x.dtype), wu.to(x.dtype), wd.to(x.dtype),
                    None if group is None else torch.float32)
    if group is not None and not defer_psum:
        # ff hidden dim was model-sharded
        y = coll.psum(y, group).to(x.dtype)
    if world is not None:
        aux = coll.pmean(aux, world)
    # with defer_psum the (float32) partial sums ride through the (linear)
    # combine and are reduce-scattered by the caller
    return _combine(y, slot, tok, gate, n), aux


def _local_ep(x, router_w, wg, wu, wd, cfg: ModelConfig, group, A: int,
              world):
    n, d = x.shape
    E = cfg.n_experts
    C = _capacity(n, cfg)
    buf, slot, tok, gate, aux = _dispatch(x, router_w, cfg, C)
    # scatter expert blocks to their owners; gather all ranks' slots
    buf = coll.all_to_all(buf.reshape(A, E // A, C, d), group)
    buf = buf.transpose(0, 1).reshape(E // A, A * C, d)  # my experts, all slots
    y = _expert_ffn(buf, wg.to(x.dtype), wu.to(x.dtype), wd.to(x.dtype))
    y = y.reshape(E // A, A, C, d).transpose(0, 1)       # (A, E/A, C, d)
    y = coll.all_to_all(y, group).reshape(E, C, d)       # global expert order
    aux = coll.pmean(aux, world)
    return _combine(y, slot, tok, gate, n), aux


def _ranks_moe(x, wb: dict, cfg: ModelConfig, mesh):
    """The reference's ``shard_map`` branches of ``moe_ffn`` on this rank
    of ``mesh`` (module docstring)."""
    B, T, d = x.shape
    baxes = batch_axes_for(B, mesh)
    msz = mesh.shape["model"]
    model, _ = mesh.group(("model",))
    world, _ = mesh.group(mesh.axis_names)
    use_ep = (cfg.moe_parallelism == "ep" and cfg.n_experts % msz == 0
              and T % msz == 0)
    scatter = not use_ep and cfg.moe_scatter_out and T % msz == 0
    M = ("model",)
    if use_ep:
        spec_x = spec_out = (baxes, M)
        spec_w = ((), (M,), (M,), (M,))
    else:
        spec_x = (baxes,)
        spec_w = ((), ((), (), M), ((), (), M), ((), M))
        spec_out = (baxes, M) if scatter else (baxes,)
    # the ranks holding one block of x must agree on it bit for bit: their
    # partial sums meet slot by slot (or token by token, the scatter)
    xl = coll.shard(x, spec_x, mesh, agree=not use_ep)
    router, wg, wu, wd = (coll.shard(wb[k], sp, mesh) for k, sp in
                          zip(("router", "wg", "wu", "wd"), spec_w))
    Bl, Tl, _ = xl.shape
    if use_ep:
        y, aux = _local_ep(xl.reshape(-1, d), router, wg, wu, wd, cfg,
                           model, msz, world)
        y = y.reshape(Bl, Tl, d)
    else:
        y, aux = _local_tp(xl.reshape(-1, d), router, wg, wu, wd, cfg,
                           model, world, defer_psum=scatter)
        y = y.reshape(Bl, Tl, d)
        if scatter:
            # reduce-scatter the combined output along seq instead of
            # all-reducing the (E,C,d) expert buffer: 1/msz the bytes
            y = coll.psum_scatter(y, model, 1).to(x.dtype)
    return (coll.assemble(y, (B, T, d), spec_out, mesh),
            coll.assemble(aux, (), (), mesh))


def moe_ffn(x: torch.Tensor, wb: dict, cfg: ModelConfig):
    """x: (B,T,d) -> ((B,T,d), aux load-balance loss)."""
    mesh = current_mesh()
    if isinstance(mesh, RankMesh) and "model" in mesh.axis_names:
        return _ranks_moe(x, wb, cfg, mesh)
    B, T, d = x.shape
    y, aux = _local_tp(x.reshape(-1, d), wb["router"], wb["wg"], wb["wu"],
                       wb["wd"], cfg)
    return y.reshape(B, T, d), aux


def ep_rules(cfg: ModelConfig) -> dict:
    """Sharding-rule override when experts are model-sharded."""
    if cfg.moe_parallelism == "ep":
        return {"expert": ("model",), "mlp": ()}
    return {}
