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

* ``"tp"``, tensor parallelism on ``model`` for every family: the
  transformers ``dense``, ``moe`` and ``vlm`` (qwen3-0.6b,
  granite-moe-1b-a400m, internvl2-2b, ...), ``ssm`` (rwkv6-7b),
  ``hybrid`` (zamba2-7b) and ``encdec`` (seamless-m4t-large-v2), each
  where the reference's rules shard its heads and FFN over ``model``.
  rwkv6, zamba2 and seamless run their models' own block functions
  (``rwkv6.block_apply``, ``mamba2.block_apply``, ``zamba2.shared_attn``,
  ``encdec.encoder_block`` and ``decoder_block``) on this rank's weights
  with ``_Plan`` as their tensor-parallel hooks (``layers.Whole`` on one
  process): the gather, the row-parallel sum, the column slice, the
  sequence block and the split norm below.
  - Column-parallel products on the ``model``-sharded output dimension:
    the attention's ``wq``/``wk``/``wv`` and the FFN's ``wg``/``wu``;
    rwkv6's ``Wr``/``Wk``/``Wv``/``Wg`` (its heads) and ``Wck``; mamba2's
    ``Wz``/``Wx`` (its ``d_in`` columns, whose heads ``Wdt``, ``dt_bias``,
    ``A_log`` and ``D`` split alike).  Each rank computes its heads and
    its columns: the WKV and SSD recurrences, rwkv6's head norm and
    bonus, mamba2's depthwise conv are local to them.  KV heads that do
    not divide ``model`` are replicated (``spec_for`` falls back on
    divisibility), and each rank takes the KV heads its query heads group
    with.  rwkv6's decay LoRA gives ``w`` over all of ``d``; each rank
    takes its heads' columns of ``Bw`` and ``w0``.  A leaf the rules
    leave replicated over ``model`` (rwkv6's ``Wcr``, mamba2's ``WB`` and
    ``WC``) is applied whole on every rank.
  - Row-parallel products (``wo``, ``wd``, rwkv6's ``Wo`` and ``Wcv``,
    mamba2's ``Wo``): a rank's partial product is kept in float32 and
    summed over ``model`` (``psum``) before it meets the residual stream
    in the compute dtype, at the reference's ``constrain(...,
    "seq_res", ...)`` sites.  rwkv6's receptance gate multiplies the
    summed ``Wcv`` output.  mamba2's gated RMSNorm spans all of ``d_in``:
    its sum of squares is a ``psum`` over ``model`` (``_norm_sum``)
    before the rsqrt.
  - Sequence parallelism: where ``T % model == 0`` the residual stream
    between blocks is cut along the sequence over ``model``, as
    ``seq_res`` lays it out; the row-parallel sums are reduce-scatters
    (``psum_scatter``) and each norm's output is all-gathered before the
    next column-parallel product (rwkv6's token shift reads the previous
    token across a block edge from it).  zamba2's embedding ``x0``, which
    its shared attention reads, is held in the same layout.  seamless's
    encoder is cut by its own length and its output all-gathered once per
    step, for every decoder layer's cross K/V.  Elsewhere the stream is
    replicated.
  - The embedding ``("vocab", "embed")``: each rank looks up the rows it
    holds, zeroes the others, and the sum over ``model`` (or its
    reduce-scatter) completes the lookup; a vlm's ``prefix_embeds``
    (rows of the batch, as its tokens) replace the first P positions.
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
* ``"generic"``, a layout whose heads or FFN do not split over
  ``model`` (a dense transformer, rwkv6, zamba2 or seamless whose heads,
  ``mlp`` or mamba2 heads do not divide it, so the rules replicate them):
  the whole parameter tree is gathered over every axis it is sharded on,
  the ``model`` ranks agree on their data block's floating inputs and
  compute it redundantly, and each rank keeps its block of the reduced
  gradient.  No family takes the single-rank path under a ``RankMesh``.

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
from . import encdec, mamba2, remat, rwkv6, zamba2
from . import moe as moe_mod
from .layers import compute_dtype, rms_norm
from .transformer import _attn_proj


def _model_dims(spec, ndim: int) -> tuple:
    """The dimensions of a leaf that ``spec`` shards over ``model``."""
    return tuple(i for i, axes in enumerate(spec_axes(spec, ndim))
                 if "model" in axes)


#: per family: {subtree: (leading stacked dimensions, {leaf: (a layer's
#: rank, the dimensions "model" must shard)})}
_ATTN = {"wq": (3, (1,)), "wo": (3, (0,))}
_FFN = {"wg": (2, (1,)), "wu": (2, (1,)), "wd": (2, (0,))}
_MAMBA = {"Wz": (2, (1,)), "Wx": (2, (1,)), "conv": (2, (1,)),
          "norm": (1, (0,)), "Wo": (2, (0,)), "Wdt": (2, (1,)),
          "dt_bias": (1, (0,)), "A_log": (1, (0,)), "D": (1, (0,))}
_WANT = {
    "ssm": {"blocks": (1, {**{k: (3, (1,)) for k in ("Wr", "Wk", "Wv",
                                                      "Wg")},
                           "Wo": (3, (0,)), "u": (2, (0,)),
                           "ln_x": (2, (0,)), "Wck": (2, (1,)),
                           "Wcv": (2, (0,))})},
    "hybrid": {"groups": (2, _MAMBA), "tail": (1, _MAMBA),
               "shared_attn": (0, _ATTN)},
    "encdec": {"enc_blocks": (1, {**_ATTN, **_FFN}),
               "dec_blocks": (1, {**_ATTN, **_FFN, "x_wq": (3, (1,)),
                                  "x_wo": (3, (0,))})},
}


def _transformer_want(cfg: ModelConfig) -> dict:
    want = dict(_ATTN)
    if cfg.n_experts:
        if cfg.moe_parallelism == "ep":
            want.update(wg=(3, (0,)), wu=(3, (0,)), wd=(3, (0,)))
        else:
            want.update(wg=(3, (2,)), wu=(3, (2,)), wd=(3, (1,)))
    else:
        want.update(_FFN)
    return {"blocks": (1, want)}


def _kv_groups_split(H: int, KV: int, M: int) -> bool:
    """Whether each rank's ``H // M`` query heads take whole KV heads (or
    share one): the KV heads shard over ``model`` or group with them."""
    G, Hl = H // KV, H // M
    return KV % M == 0 or Hl % G == 0 or G % Hl == 0


def path_for(cfg: ModelConfig, mesh, pspecs) -> str:
    """``"tp"`` or ``"generic"`` (module docstring): ``"tp"`` where the
    rules shard every leaf the family's tensor parallelism splits over
    ``model`` as it needs.  An MoE transformer whose layout does not split
    so raises ``ValueError``: its ``shard_map`` bodies have no generic
    form."""
    M = mesh.shape.get("model", 1)
    want = (_WANT[cfg.family] if cfg.family in _WANT
            else _transformer_want(cfg))
    ok = M == 1 or all(
        _model_dims(pspecs[sub][k][lead:], nd) == dims
        for sub, (lead, leaves) in want.items() if sub in pspecs
        for k, (nd, dims) in leaves.items())
    if ok and M > 1 and cfg.n_kv_heads:
        ok = _kv_groups_split(cfg.padded_heads, cfg.n_kv_heads, M)
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
                   "wd", "x_wq", "x_wk", "x_wv", "x_wo", "Wr", "Wk", "Wv",
                   "Wg", "Wo", "Wck", "Wcv", "Wcr", "Wz", "Wx", "WB", "WC",
                   "conv")


def _gather_dtype(key: str, x: torch.Tensor, lead: int, cast, compute):
    """The dtype a leaf is gathered in (None: its own).  ``x`` is a layer's
    slice of a leaf stacked over ``lead`` dimensions.  ``cast`` is
    ``cast_params_bf16``'s, which the reference applies to every float32
    leaf of more than one dimension (a stacked norm too); otherwise a leaf
    the model always uses in the ``compute`` dtype is gathered in it."""
    if x.dtype != torch.float32:
        return None
    if cast is not None and x.ndim + lead > 1:
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


def _norm_sum(ss, mg):
    """mamba2's gated norm: a rank's sum of squares over its ``d_in``
    columns, summed over ``model``."""
    return coll.psum(ss, mg)


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
    """What the TP path reads of the mesh and the config, for a residual
    stream of ``T`` positions."""

    def __init__(self, cfg: ModelConfig, mesh, T: int, cast):
        self.cfg, self.mesh, self.cast = cfg, mesh, cast
        self.M = mesh.shape["model"]
        self.m = mesh.coords["model"]
        self.mg = mesh.group(("model",))[0] if self.M > 1 else None
        self.world = (mesh.group(mesh.axis_names)[0] if mesh.size > 1
                      else None)
        self.sp = self.M > 1 and T % self.M == 0
        self.dt = compute_dtype(cfg)
        self.ep = bool(cfg.n_experts) and cfg.moe_parallelism == "ep"
        if self.ep and self.M > 1 and not self.sp:
            raise ValueError(f"{cfg.name}: 'ep' needs T % model == 0, got "
                             f"T={T} on model={self.M}")
        self.scatter = (not self.ep and cfg.moe_scatter_out and self.sp)

    def gather(self, ps: dict, specs: dict, lead: int) -> dict:
        """The FSDP gather over ``data`` of one layer's blocks ``ps`` of
        leaves stacked over ``lead`` dimensions (``specs``: the stacked
        leaves')."""
        return coll.gather_params(
            ps, {k: tuple(specs[k])[lead:] for k in ps}, self.mesh,
            dtypes={k: _gather_dtype(k, v, lead, self.cast, self.dt)
                    for k, v in ps.items()})

    def kv(self, H: int, KV: int, wk_spec) -> tuple:
        """The KV heads this rank's query heads group with, when the rules
        replicate the KV heads over ``model`` (else None)."""
        if self.M == 1 or _model_dims(wk_spec, 3):
            return None
        Hl, G = H // self.M, H // KV
        lo, hi = self.m * Hl, (self.m + 1) * Hl
        return lo // G, (hi - 1) // G + 1

    # the hooks of the models' blocks (``layers.Whole``)

    def full(self, x):
        """A norm's output on this rank's sequence block, all-gathered
        for a column-parallel product (itself without sequence
        parallelism)."""
        return coll.all_gather(x, self.mg, 1) if self.sp else x

    def seq(self, x):
        return _seq_block(x, self.mesh) if self.sp else x

    def cols(self, x):
        n = x.shape[-1] // self.M
        return x[..., self.m * n:(self.m + 1) * n]

    def row(self, x, w, eq=None):
        """The rank's float32 partial product, summed over ``model``,
        in ``x``'s dtype."""
        part = (x.float() @ w.float() if eq is None else
                torch.einsum(eq, x.float(), w.float()))
        return self.row_sum(part).to(x.dtype)

    def norm(self, x, w, eps: float = 1e-6):
        """``rms_norm`` over a last dimension split over ``model``: the
        rank's sum of squares summed over it (``_norm_sum``)."""
        dt, x = x.dtype, x.float()
        ss = (x * x).sum(dim=-1, keepdim=True)
        if self.mg is not None:
            ss = _norm_sum(ss, self.mg)
        x = x * torch.rsqrt(ss / (x.shape[-1] * self.M) + eps)
        return (x * w.float()).to(dt)

    def row_sum(self, part):
        return _row_sum(part, self.mg, self.sp)


def _layer(tree: dict, *idx) -> dict:
    out = tree
    for i in idx:
        out = {k: v[i] for k, v in out.items()}
    return out


def _take_kv(w: dict, kv, prefix: str = "") -> dict:
    if kv is not None:
        lo, hi = kv
        for k in ("wk", "wv"):
            w[prefix + k] = w[prefix + k][:, lo:hi]
    return w


def _attention(x, w, plan: _Plan, positions, causal: bool):
    """Self-attention of the replicated normed ``x`` over this rank's
    heads; returns the row-parallel output in the residual's layout."""
    q, k, v = _attn_proj(x, w, plan.cfg, positions)
    o = kops.flash_attention(q, k, v, causal=causal,
                             window=plan.cfg.sliding_window,
                             block_kv=plan.cfg.attn_chunk_kv)
    return plan.row(o, w["wo"], "bthk,hkd->btd")


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
    x = plan.full(x)
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
    return plan.row(h, w["wd"]), 0.0


def _tp_block(h, wl, plan: _Plan, specs, kv, positions):
    """One decoder block on this rank; h is the residual stream (this
    rank's sequence block under sequence parallelism)."""
    w = _take_kv(plan.gather(wl, specs, 1), kv)
    x = plan.full(rms_norm(h, w["ln1"]))
    h = h + _attention(x, w, plan, positions, True)
    y, aux = _tp_ffn(rms_norm(h, w["ln2"]), w, plan)
    return h + y, aux


def _embed(plan: _Plan, shards, pspecs, tokens, prefix=None):
    """The vocab-sharded lookup of ``tokens`` (B, T) in the residual's
    layout, the first P positions replaced by ``prefix`` (B, P, d)."""
    emb = plan.gather({"embed": shards["embed"]}, pspecs, 0)["embed"]
    vocab_split = bool(_model_dims(pspecs["embed"], 2))
    v0 = plan.m * emb.shape[0] if vocab_split else 0
    local = tokens - v0
    held = (local >= 0) & (local < emb.shape[0])
    e = emb[local.clamp(0, emb.shape[0] - 1)].to(plan.dt) * held[..., None]
    if vocab_split and plan.mg is not None:
        h = plan.row_sum(e.float()).to(plan.dt)
    else:
        h = _seq_block(e, plan.mesh) if plan.sp else e
    if prefix is None:
        return h
    T, P = tokens.shape[1], prefix.shape[1]
    if T < P:
        raise ValueError(f"a sequence of {T} tokens is shorter than its "
                         f"prefix of {P} patch positions")
    Tl = h.shape[1]
    pos = torch.arange(Tl, device=h.device) + (plan.m * Tl if plan.sp
                                               else 0)
    pre = prefix[:, pos.clamp(max=P - 1)].to(h.dtype)
    return torch.where((pos < P)[None, :, None], pre, h)


def _head_loss(plan: _Plan, h, shards, pspecs, batch, ln_f="ln_f"):
    """The global loss from the residual stream after the last block: the
    final norm, the vocab-sharded LM head and ``vocab_cross_entropy``
    (z-loss 1e-4, optional ``mask``), the token mean over the batch."""
    top = plan.gather({k: shards[k] for k in (ln_f, "lm_head")}, pspecs, 0)
    h = plan.full(rms_norm(h, top[ln_f]))
    logits = torch.einsum("btd,dv->btv", h,
                          top["lm_head"].to(h.dtype)).float()
    split = bool(_model_dims(pspecs["lm_head"], 2))
    total, count = vocab_cross_entropy(
        logits, batch["labels"], plan.m * logits.shape[-1] if split else 0,
        plan.mg if split else None, z_loss=1e-4, mask=batch.get("mask"))
    return _global_mean(total, count, plan.mesh)


def _transformer_loss(api, shards, batch, mesh, pspecs, cast):
    cfg = api.cfg
    tokens = batch["tokens"]
    T = tokens.shape[1]
    plan = _Plan(cfg, mesh, T, cast)
    specs = pspecs["blocks"]
    kv = plan.kv(cfg.padded_heads, cfg.n_kv_heads, tuple(specs["wk"])[1:])
    h = _embed(plan, shards, pspecs, tokens, batch.get("prefix_embeds"))
    positions = torch.arange(T, device=h.device)

    def body(hh, wl):
        return _tp_block(hh, wl, plan, specs, kv, positions)

    aux_sum = 0.0
    for li in range(cfg.n_layers):
        h, aux = remat.block(cfg, body, h, _layer(shards["blocks"], li))
        aux_sum = aux_sum + aux
    loss = _head_loss(plan, h, shards, pspecs, batch)
    if cfg.n_experts:
        loss = loss + 0.01 * aux_sum / cfg.n_layers
    return loss


# ----------------------------------------------------------------- rwkv6

def _rwkv_block(h, wl, plan: _Plan, specs):
    """One RWKV-6 block (``rwkv6.block_apply`` from a zero state) on this
    rank's heads and ``mlp`` columns."""
    w = plan.gather(wl, specs, 1)
    B, d, hd = h.shape[0], plan.cfg.d_model, plan.cfg.hd
    zero = h.new_zeros((B, d))
    S0 = torch.zeros((B, w["Wr"].shape[1], hd, hd), dtype=torch.float32,
                     device=h.device)
    return rwkv6.block_apply(h, w, plan.cfg, {"prev_att": zero,
                                             "prev_ffn": zero, "S": S0},
                             plan)[0]


def _rwkv_loss(api, shards, batch, mesh, pspecs, cast):
    cfg = api.cfg
    plan = _Plan(cfg, mesh, batch["tokens"].shape[1], cast)
    specs = pspecs["blocks"]
    h = _embed(plan, shards, pspecs, batch["tokens"])

    def body(hh, wl):
        return _rwkv_block(hh, wl, plan, specs)

    for li in range(cfg.n_layers):
        h = remat.block(cfg, body, h, _layer(shards["blocks"], li))
    return _head_loss(plan, h, shards, pspecs, batch)


# ---------------------------------------------------------------- zamba2

def _mamba_block(h, wl, plan: _Plan, specs, lead: int):
    """One Mamba2 block (``mamba2.block_apply`` from a zero state) on this
    rank's ``d_in`` columns and their heads."""
    w = plan.gather(wl, specs, lead)
    _, _, P, N, _ = mamba2.dims(plan.cfg)
    S0 = torch.zeros((h.shape[0], w["A_log"].shape[0], P, N),
                     dtype=torch.float32, device=h.device)
    return mamba2.block_apply(h, w, plan.cfg, {"conv": None, "S": S0},
                              plan)[0]


def _zamba_loss(api, shards, batch, mesh, pspecs, cast):
    cfg = api.cfg
    T = batch["tokens"].shape[1]
    plan = _Plan(cfg, mesh, T, cast)
    k_grp, n_full, tail = zamba2._split(cfg)
    sa_specs = pspecs["shared_attn"]
    kv = plan.kv(cfg.n_heads, cfg.n_kv_heads, sa_specs["wk"])
    # one gather of the shared block for its 1 + n_full applications
    sw = _take_kv(plan.gather(shards["shared_attn"], sa_specs, 0), kv)
    h = _embed(plan, shards, pspecs, batch["tokens"])
    x0 = h
    positions = torch.arange(T, device=h.device)

    def body(specs, lead):
        return lambda hh, wl: _mamba_block(hh, wl, plan, specs, lead)

    def shared(hh):
        return zamba2.shared_attn(hh, x0, sw, cfg, positions, tp=plan)[0]

    for g in range(n_full):
        h = shared(h)
        for i in range(k_grp):
            h = remat.block(cfg, body(pspecs["groups"], 2), h,
                            _layer(shards["groups"], g, i))
    if tail:
        h = shared(h)
        for i in range(tail):
            h = remat.block(cfg, body(pspecs["tail"], 1), h,
                            _layer(shards["tail"], i))
    return _head_loss(plan, h, shards, pspecs, batch)


# ---------------------------------------------------------------- encdec

def _encdec_loss(api, shards, batch, mesh, pspecs, cast):
    """``encdec.encoder_block`` and ``decoder_block`` on this rank's heads
    and ``mlp`` columns; the decoder's cross-attention over the encoder
    output, all-gathered once, with this rank's heads and their K/V."""
    cfg = api.cfg
    frames, tokens = batch["frame_embeds"], batch["tokens"]
    H, KV = cfg.n_heads, cfg.n_kv_heads
    es, ds = pspecs["enc_blocks"], pspecs["dec_blocks"]
    # the encoder's stream is cut by its own length
    pe = _Plan(cfg, mesh, frames.shape[1], cast)
    kv_e = pe.kv(H, KV, tuple(es["wk"])[1:])
    h = frames.to(pe.dt)
    h = _seq_block(h, mesh) if pe.sp else h
    pos_e = torch.arange(frames.shape[1], device=h.device)

    def enc_body(hh, wl):
        w = _take_kv(pe.gather(wl, es, 1), kv_e)
        return encdec.encoder_block(hh, w, cfg, pos_e, pe)[0]

    for i in range(cfg.n_enc_layers):
        h = remat.block(cfg, enc_body, h, _layer(shards["enc_blocks"], i))
    ln = pe.gather({"enc_ln_f": shards["enc_ln_f"]}, pspecs, 0)["enc_ln_f"]
    enc = pe.full(rms_norm(h, ln))          # once per step, for every layer
    pd = _Plan(cfg, mesh, tokens.shape[1], cast)
    kv_d = pd.kv(H, KV, tuple(ds["wk"])[1:])
    xkv = pd.kv(H, KV, tuple(ds["x_wk"])[1:])
    h = _embed(pd, shards, pspecs, tokens)
    pos_d = torch.arange(tokens.shape[1], device=h.device)

    def dec_body(hh, wl, ee):
        w = _take_kv(_take_kv(pd.gather(wl, ds, 1), kv_d), xkv, "x_")
        return encdec.decoder_block(hh, w, ee, cfg, pos_d, pd)[0]

    for i in range(cfg.n_layers):
        h = remat.block(cfg, dec_body, h, _layer(shards["dec_blocks"], i),
                        enc)
    return _head_loss(pd, h, shards, pspecs, batch)


_TP_LOSS = {"ssm": _rwkv_loss, "hybrid": _zamba_loss,
            "encdec": _encdec_loss}


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
        fn = _TP_LOSS.get(api.cfg.family, _transformer_loss)
        return fn(api, shards, batch, mesh, pspecs, cast)
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
