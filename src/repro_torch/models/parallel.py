"""The model's loss on one rank of a ``launch.mesh.RankMesh``, from this
rank's shards of the parameters and its rows of the batch: the body of the
sharded train step (``train.train_loop.jit_train_step``), the port's
counterpart of what the reference's SPMD partitioner makes of its
``jit_train_step`` on a (data, model) mesh.

Every rank holds its block of each parameter under the reference's
``PartitionSpec`` (``sharding.rules.named_sharding``).  Each layer's
weights are gathered over ``data`` when the layer runs
(``collectives.gather_params``, FSDP) inside its rematerialised block, so
the backward gathers them again rather than holding every full layer; the
gather's transpose reduce-scatters the gradient back into the block,
summed over the ``data`` ranks, which is the data-parallel reduction.  A
weight that every use casts to the compute dtype is cast before its
gather (bf16 moves 2 bytes per element; the values are the ones the cast
at use gives); with ``cast_params_bf16`` every float32 leaf of more than
one dimension is, as in the reference.

Two paths (``path_for``):

* ``"tp"``, the transformer families ``dense`` and ``moe`` (qwen3-0.6b,
  granite-moe-1b-a400m, ...): tensor parallelism on ``model``.
  - ``wq``/``wk``/``wv`` and the FFN's ``wg``/``wu`` are column-parallel:
    each rank computes its heads and its ``mlp`` columns.  KV heads that
    do not divide ``model`` are replicated (``spec_for`` falls back on
    divisibility), and each rank takes the KV heads its query heads group
    with.
  - ``wo`` and ``wd`` are row-parallel: a rank's partial product is kept
    in float32 and summed over ``model`` (``psum``) before it meets the
    residual stream in the compute dtype, at the reference's
    ``constrain(..., "seq_res", ...)`` sites.
  - Sequence parallelism: where ``T % model == 0`` the residual stream
    between blocks is cut along the sequence over ``model``, as
    ``seq_res`` lays it out; the row-parallel sums are reduce-scatters
    (``psum_scatter``) and each norm's output is all-gathered before the
    next column-parallel product.  Elsewhere the stream is replicated.
  - The embedding ``("vocab", "embed")``: each rank looks up the rows it
    holds, zeroes the others, and the sum over ``model`` (or its
    reduce-scatter) completes the lookup.
  - The LM head gives logits sharded over the vocabulary;
    ``vocab_cross_entropy`` takes its log-sum-exp through a ``pmax`` and
    a ``psum`` over ``model`` and the label logit by the reference's
    compare-and-select reduction on the local shard plus the same
    ``psum``.  No rank gathers the full logits.
  - The MoE FFN runs ``moe.py``'s ``shard_map`` bodies (``moe._local_tp``,
    ``moe._local_ep``) on this rank's tokens, as the reference's
    ``shard_map`` splits them: "tp" over the batch axes with the ranks of
    one block agreeing on its input (``collectives.agree``: their
    partial sums meet slot by slot), "ep" over the batch axes and, over
    ``model``, the sequence.
* ``"generic"``, every other family (rwkv6, mamba2/zamba2, encdec, the VLM
  prefix) and a dense transformer whose heads or FFN do not split over
  ``model``: the whole parameter tree is gathered over every axis it is
  sharded on, the ``model`` ranks agree on their data block's floating
  inputs and compute it redundantly, and each rank keeps its block of the
  reduced gradient.  Tensor parallelism for these families is ROADMAP §A
  work; they never take the single-rank path under a ``RankMesh``.

The loss is the token mean over the global batch: each rank's sum of
token losses and token count are summed over the batch axes before the
division, so an uneven ``mask`` weighs every token alike.  The value is
the same on every rank; the step seeds its gradient with ``1 / world``
on each rank, the convention of ``sharding.collectives``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from ..sharding import collectives as coll
from ..sharding.rules import sharding_ctx, spec_axes
from . import moe as moe_mod
from . import remat
from .layers import compute_dtype, rms_norm
from .transformer import _attn_proj

TP_FAMILIES = ("dense", "moe")


def _model_dims(spec, ndim: int) -> tuple:
    """The dimensions of a leaf that ``spec`` shards over ``model``."""
    return tuple(i for i, axes in enumerate(spec_axes(spec, ndim))
                 if "model" in axes)


def path_for(cfg: ModelConfig, mesh, pspecs) -> str:
    """``"tp"`` or ``"generic"`` (module docstring).  An MoE transformer
    whose layout does not split as the TP path needs raises
    ``ValueError``: its ``shard_map`` bodies have no generic form."""
    if cfg.family not in TP_FAMILIES:
        return "generic"
    M = mesh.shape.get("model", 1)
    b = pspecs["blocks"]
    # a layer's leaf (the stacked leaf less its "layers" dimension): its
    # rank and the dimensions "model" must shard
    want = {"wq": (3, (1,)), "wo": (3, (0,))}
    if cfg.n_experts:
        if cfg.moe_parallelism == "ep":
            want.update(wg=(3, (0,)), wu=(3, (0,)), wd=(3, (0,)))
        else:
            want.update(wg=(3, (2,)), wu=(3, (2,)), wd=(3, (1,)))
    else:
        want.update(wg=(2, (1,)), wu=(2, (1,)), wd=(2, (0,)))
    H, KV = cfg.padded_heads, cfg.n_kv_heads
    G, Hl = H // KV, H // M
    ok = M == 1 or (
        all(_model_dims(b[k][1:], nd) == dims
            for k, (nd, dims) in want.items()) and
        (KV % M == 0 or Hl % G == 0 or G % Hl == 0))
    if ok:
        return "tp"
    if cfg.n_experts:
        raise ValueError(f"{cfg.name}: an MoE layer's heads, experts or FFN "
                         f"do not split over model={M} as the sharded "
                         f"step's tensor parallelism needs")
    return "generic"


#: the leaves every use of which casts them to the compute dtype first:
#: gathering them in it moves fewer bytes and gives the same values
_COMPUTE_LEAVES = ("embed", "lm_head", "wq", "wk", "wv", "wo", "wg", "wu",
                   "wd")


def _gather_dtype(key: str, stacked: torch.Tensor, cast, compute):
    """The dtype a leaf is gathered in (None: its own).  ``cast`` is
    ``cast_params_bf16``'s, which the reference applies to every float32
    leaf of more than one dimension (a stacked norm too); otherwise a leaf
    the model always uses in the ``compute`` dtype is gathered in it."""
    if stacked.dtype != torch.float32:
        return None
    if cast is not None and stacked.ndim > 1:
        return cast
    if key in _COMPUTE_LEAVES and compute.itemsize < 4:
        return compute
    return None


def _seq_block(x, mesh):
    """This rank's block of a replicated ``x`` along the sequence."""
    M, m = mesh.shape["model"], mesh.coords["model"]
    T = x.shape[1] // M
    return x[:, m * T:(m + 1) * T]


def _row_sum(part, mg, sp: bool):
    """A row-parallel product's float32 partial, summed over ``model``
    (reduce-scattered along the sequence under sequence parallelism)."""
    if mg is None:
        return part
    return coll.psum_scatter(part, mg, 1) if sp else coll.psum(part, mg)


def vocab_cross_entropy(logits, labels, v0: int, mg, z_loss: float = 0.0,
                        mask=None):
    """(sum of token losses, token count) of ``layers.cross_entropy`` over
    logits that hold vocabulary entries ``[v0, v0 + V_local)`` on this
    rank of ``mg`` (all of them when ``mg`` is None); float32."""
    logits = logits.float()
    mx = logits.detach().amax(dim=-1)
    if mg is not None:
        mx = coll.pmax(mx, mg)
    se = torch.exp(logits - mx[..., None]).sum(dim=-1)
    V = logits.shape[-1]
    hit = (labels - v0)[..., None] == torch.arange(V, device=logits.device)
    ll = torch.where(hit, logits, 0.0).sum(dim=-1)
    if mg is not None:
        se, ll = coll.psum(torch.stack([se, ll]), mg).unbind(0)
    lse = torch.log(se) + mx
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    if mask is not None:
        return (loss * mask).sum(), mask.sum().to(torch.float32)
    return loss.sum(), torch.tensor(float(loss.numel()),
                                    device=loss.device)


def _global_mean(total, count, mesh):
    """``total / count`` with both summed over the batch axes (``data``)."""
    both = torch.stack([total, count.to(total.dtype)])
    if mesh.shape.get("data", 1) > 1:
        both = coll.psum(both, mesh.group(("data",))[0])
    total, count = both.unbind(0)
    return total / torch.clamp_min(count, 1)


# --------------------------------------------------------------- tp path

class _Plan:
    """What the TP path reads of the mesh, the specs and the config."""

    def __init__(self, cfg: ModelConfig, mesh, pspecs, T: int, cast,
                 shards):
        self.cfg, self.mesh = cfg, mesh
        self.M = mesh.shape["model"]
        self.m = mesh.coords["model"]
        self.mg = mesh.group(("model",))[0] if self.M > 1 else None
        self.world = (mesh.group(mesh.axis_names)[0] if mesh.size > 1
                      else None)
        self.sp = self.M > 1 and T % self.M == 0
        self.specs = {k: v[1:] for k, v in pspecs["blocks"].items()}
        self.kv_sharded = bool(_model_dims(self.specs["wk"], 3))
        H, KV = cfg.padded_heads, cfg.n_kv_heads
        Hl = H // self.M
        lo, hi = self.m * Hl, (self.m + 1) * Hl
        # the KV heads this rank's query heads group with
        self.kv = (None if self.kv_sharded or self.M == 1 else
                   (lo // (H // KV), (hi - 1) // (H // KV) + 1))
        self.ep = bool(cfg.n_experts) and cfg.moe_parallelism == "ep"
        if self.ep and self.M > 1 and not self.sp:
            raise ValueError(f"{cfg.name}: 'ep' needs T % model == 0, got "
                             f"T={T} on model={self.M}")
        self.scatter = (not self.ep and cfg.moe_scatter_out and self.sp)
        dt = compute_dtype(cfg)
        self.dtypes = {k: _gather_dtype(k, v, cast, dt)
                       for k, v in list(shards["blocks"].items()) +
                       [(k, shards[k]) for k in ("embed", "lm_head", "ln_f")]}

    def gather(self, ps: dict, specs: dict) -> dict:
        return coll.gather_params(ps, specs, self.mesh, dtypes=self.dtypes)


def _tp_ffn(x, w, plan: _Plan):
    """The FFN on ``x`` (after ``ln2``; this rank's sequence block under
    sequence parallelism); returns (output in the residual's layout, aux)."""
    cfg, mg, sp = plan.cfg, plan.mg, plan.sp
    if cfg.n_experts and plan.ep:
        B, Tl, d = x.shape
        y, aux = moe_mod._local_ep(
            x.reshape(-1, d), w["router"], w["wg"], w["wu"], w["wd"], cfg,
            mg, plan.M, plan.world)
        return y.reshape(B, Tl, d), aux
    if sp:
        x = coll.all_gather(x, mg, 1)
    if cfg.n_experts:
        if mg is not None:
            x = coll.agree(x, plan.mesh, ("model",))
        B, T, d = x.shape
        y, aux = moe_mod._local_tp(
            x.reshape(-1, d), w["router"], w["wg"], w["wu"], w["wd"], cfg,
            mg, plan.world, defer_psum=plan.scatter)
        y = y.reshape(B, T, d)
        if plan.scatter:
            return coll.psum_scatter(y, mg, 1).to(x.dtype), aux
        return (_seq_block(y, plan.mesh) if sp else y), aux
    h = F.silu(x @ w["wg"].to(x.dtype)) * (x @ w["wu"].to(x.dtype))
    part = h.float() @ w["wd"].float()
    return _row_sum(part, mg, sp).to(x.dtype), 0.0


def _tp_block(h, wl, plan: _Plan, positions):
    """One decoder block on this rank; h is the residual stream (this
    rank's sequence block under sequence parallelism)."""
    w = plan.gather(wl, plan.specs)
    if plan.kv is not None:
        lo, hi = plan.kv
        w["wk"], w["wv"] = w["wk"][:, lo:hi], w["wv"][:, lo:hi]
    x = rms_norm(h, w["ln1"])
    if plan.sp:
        x = coll.all_gather(x, plan.mg, 1)
    q, k, v = _attn_proj(x, w, plan.cfg, positions)
    o = kops.flash_attention(q, k, v, causal=True,
                             window=plan.cfg.sliding_window,
                             block_kv=plan.cfg.attn_chunk_kv)
    part = torch.einsum("bthk,hkd->btd", o.float(), w["wo"].float())
    h = h + _row_sum(part, plan.mg, plan.sp).to(h.dtype)
    y, aux = _tp_ffn(rms_norm(h, w["ln2"]), w, plan)
    return h + y, aux


def _tp_loss(api, shards, batch, mesh, pspecs, cast):
    cfg = api.cfg
    tokens, labels = batch["tokens"], batch["labels"]
    T = tokens.shape[1]
    plan = _Plan(cfg, mesh, pspecs, T, cast, shards)
    mg, sp = plan.mg, plan.sp
    dt = compute_dtype(cfg)
    emb = plan.gather({"embed": shards["embed"]}, pspecs)["embed"]
    vocab_split = bool(_model_dims(pspecs["embed"], 2))
    v0 = plan.m * emb.shape[0] if vocab_split else 0
    local = tokens - v0
    held = (local >= 0) & (local < emb.shape[0])
    e = emb[local.clamp(0, emb.shape[0] - 1)].to(dt) * held[..., None]
    if vocab_split and mg is not None:
        h = _row_sum(e.float(), mg, sp).to(dt)
    else:
        h = _seq_block(e, mesh) if sp else e
    positions = torch.arange(T, device=h.device)

    def body(hh, wl):
        return _tp_block(hh, wl, plan, positions)

    aux_sum = 0.0
    for li in range(cfg.n_layers):
        wl = {k: v[li] for k, v in shards["blocks"].items()}
        h, aux = remat.block(cfg, body, h, wl)
        aux_sum = aux_sum + aux
    top = plan.gather({k: shards[k] for k in ("ln_f", "lm_head")}, pspecs)
    h = rms_norm(h, top["ln_f"])
    if sp:
        h = coll.all_gather(h, mg, 1)
    head = top["lm_head"]
    logits = torch.einsum("btd,dv->btv", h, head.to(h.dtype)).float()
    total, count = vocab_cross_entropy(
        logits, labels, plan.m * logits.shape[-1] if vocab_split else 0,
        mg if vocab_split else None, z_loss=1e-4, mask=batch.get("mask"))
    loss = _global_mean(total, count, mesh)
    if cfg.n_experts:
        loss = loss + 0.01 * aux_sum / cfg.n_layers
    return loss


# ---------------------------------------------------------- generic path

def _generic_loss(api, shards, batch, mesh, pspecs, cast):
    from ..train.checkpoint import _flatten, _unflatten
    from ..train.train_loop import flatten_specs
    flat = _flatten(shards)
    full = _unflatten(shards, coll.gather_params(
        flat, flatten_specs(pspecs), mesh, keep=(),
        dtypes={k: cast if cast is not None and p.dtype == torch.float32
                and p.ndim > 1 else None for k, p in flat.items()}))
    if mesh.shape.get("model", 1) > 1:
        batch = {k: coll.agree(v, mesh, ("model",))
                 if torch.is_tensor(v) and v.is_floating_point() else v
                 for k, v in batch.items()}
    with sharding_ctx(None):
        loss = api.loss_fn(full, batch)
    mask = batch.get("mask")
    count = (mask.sum().to(torch.float32) if mask is not None else
             torch.tensor(float(batch["labels"].numel()),
                          device=loss.device))
    return _global_mean(loss * count, count, mesh)


def loss_fn(api, shards, batch, mesh, pspecs, cast=None) -> torch.Tensor:
    """The global loss from this rank's parameter shards and batch rows
    (module docstring), on ``path_for``'s path.  ``cast`` is the dtype
    of ``cast_params_bf16``'s compute copy (None: the masters')."""
    if path_for(api.cfg, mesh, pspecs) == "tp":
        return _tp_loss(api, shards, batch, mesh, pspecs, cast)
    return _generic_loss(api, shards, batch, mesh, pspecs, cast)


def rank_rows(global_batch: int, mesh, microbatches: int = 1):
    """The rows of a global batch that this rank takes: under
    ``batch_axes_for`` of a microbatch (``global_batch //
    microbatches`` rows), microbatch ``i``'s block ``d`` for each ``i``
    in order, ``d`` this rank's ``data`` coordinate, as the reference's
    reshape of the batch into microbatches and their split over the batch
    axes give them.  A batch that does not split over ``data`` and the
    microbatches raises ``ValueError``."""
    D = mesh.shape.get("data", 1)
    if global_batch % (D * microbatches):
        raise ValueError(f"a global batch of {global_batch} rows does not "
                         f"split into {microbatches} microbatches over "
                         f"data={D}")
    per = global_batch // microbatches
    n = per // D
    d = mesh.coords["data"]
    return [i * per + d * n + j for i in range(microbatches)
            for j in range(n)]

