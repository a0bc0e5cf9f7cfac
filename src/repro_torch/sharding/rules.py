"""Logical-axis sharding rules (MaxText-style) for all model families, the
reference package's ``sharding/rules.py`` over the port's ``ParamSpec``
trees.

Every parameter/activation dimension carries a *logical* name; this module
maps logical names to mesh axes, checking divisibility (dims that don't
divide are replicated — e.g. 8 KV heads on a 16-way model axis).  A mesh is
any object with ``axis_names`` and a ``shape`` mapping each name to its
size (``launch.mesh.Mesh``): the rules need no device.  A spec is a
``PartitionSpec``, a tuple of one entry per leading dimension (a mesh axis,
a tuple of axes, or None), trailing Nones trimmed, as the reference's.

``named_sharding(mesh, spec)`` is the counterpart of the reference's
``NamedSharding``: the block of an array that each mesh position holds,
for each dimension the slice given by the axes ``spec`` names there, in
row-major mesh order (``devices_indices_map``), and the cut of that block
out of a full tensor.  The sharded train step
(``train.train_loop.jit_train_step``) holds each rank's parameters and
moments as these blocks, and ``sharding.collectives`` computes its
blocks with it.

``constrain`` returns its input, under a ``launch.mesh.RankMesh`` too:
the reference's ``with_sharding_constraint`` is a hint to XLA's
partitioner, which the port does not have.  On ranks the layout of the
activations is set by the explicit collectives of the sharded step
(``models/parallel.py``), not by hints.  The dry-run reads the specs of a
production mesh as the reference compiles with them.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple

# logical axis -> preferred mesh axes (in priority order; filtered to the
# axes present in the mesh and to divisible sizes)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),                      # attention-internal seq dim: unsharded
    "seq_res": ("model",),          # residual stream at block boundaries:
                                    # sequence parallelism — the remat-saved
                                    # activations shard over 'model', cutting
                                    # per-device activation memory 16x
    "act_embed": (),
    "heads_act": ("model",),
    "mlp_act": ("model",),
    "kv_seq": ("model",),           # decode KV cache context parallelism
    # params
    "embed": ("data",),             # FSDP shard of the d_model dim
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": (),                   # "tp" MoE: experts replicated, ff TP'd;
                                    # "ep" overrides this to ("model",)
    "layers": (), "group": (), "head_dim": (), "state": (), "conv": (),
    "lora": (), "enc_seq": (),
}


class PartitionSpec(tuple):
    """One array's layout: an entry per dimension — a mesh axis name, a
    tuple of names, or None (replicated).  ``PartitionSpec("data",
    "model")`` equals the tuple ``("data", "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


_tls = threading.local()


@contextmanager
def sharding_ctx(mesh, rules: Optional[Dict] = None):
    """Install a mesh + rules for ``current_mesh`` (and ``constrain``)
    inside the block."""
    prev = getattr(_tls, "ctx", None)
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _tls.ctx = (mesh, merged) if mesh is not None else None
    try:
        yield
    finally:
        _tls.ctx = prev


def current_mesh():
    ctx = getattr(_tls, "ctx", None)
    return ctx[0] if ctx else None


def _axes_for(logical: Optional[str], dim: int, mesh, rules: Dict,
              used: set) -> Optional[Tuple[str, ...]]:
    if logical is None:
        return None
    cand = rules.get(logical, ())
    picked = []
    size = 1
    for ax in cand:
        if ax not in mesh.axis_names or ax in used:
            continue
        nsz = size * mesh.shape[ax]
        if dim % nsz != 0:
            continue
        picked.append(ax)
        size = nsz
    if not picked:
        return None
    used.update(picked)
    return tuple(picked)


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             mesh, rules: Optional[Dict] = None) -> PartitionSpec:
    """PartitionSpec for one array given its logical axes."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    used: set = set()
    entries = []
    for dim, name in zip(shape, logical):
        axes = _axes_for(name, dim, mesh, rules, used)
        if axes is None:
            entries.append(None)
        elif len(axes) == 1:
            entries.append(axes[0])
        else:
            entries.append(axes)
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def param_partition_specs(specs_tree, mesh, rules: Optional[Dict] = None):
    """Tree of PartitionSpec parallel to a ParamSpec tree."""
    from ..models.module import tree_map
    return tree_map(lambda s: spec_for(s.shape, s.logical, mesh, rules),
                    specs_tree)


def spec_axes(spec: Sequence, ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """A spec's entries as one tuple of mesh axes per dimension (``()``
    for a replicated one), padded to ``ndim``."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(spec)):
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return tuple(out)


class NamedSharding:
    """The reference's ``NamedSharding(mesh, spec)`` as blocks.  Dimension
    ``i`` of an array of ``shape`` is cut into ``k`` equal slices, ``k``
    the product of the sizes of the axes the spec names there; the
    position at ``coords`` holds slice ``c`` with ``c`` its coordinates
    on those axes, the first axis major.  A dimension that does not
    divide raises ``ValueError``."""

    def __init__(self, mesh, spec: Sequence):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def index(self, shape: Sequence[int], coords=None) -> tuple:
        """The slices of the block at ``coords`` (the mesh's own position,
        a ``RankMesh``'s rank, by default)."""
        coords = self.mesh.coords if coords is None else coords
        out = []
        for n, axes in zip(shape, spec_axes(self.spec, len(shape))):
            k = math.prod(self.mesh.shape[a] for a in axes)
            if n % k:
                raise ValueError(f"dimension {n} of {tuple(shape)} does not "
                                 f"split {k} ways under {self.spec}")
            i = 0
            for a in axes:
                i = i * self.mesh.shape[a] + coords[a]
            out.append(slice(i * n // k, (i + 1) * n // k))
        return tuple(out)

    def devices_indices_map(self, shape: Sequence[int]) -> Dict[int, tuple]:
        """{position (row-major over the mesh's axes): its slices}."""
        return {r: self.index(shape, self.mesh.coords_of(r))
                for r in range(math.prod(self.mesh.shape.values()))}

    def block(self, x, coords=None):
        """The block of the full ``x`` at ``coords`` (a view)."""
        return x[self.index(x.shape, coords)]

    def __repr__(self) -> str:
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec!r})"


def named_sharding(mesh, spec: Sequence) -> NamedSharding:
    return NamedSharding(mesh, spec)


def constrain(x, *logical: Optional[str]):
    """The reference's ``with_sharding_constraint`` under the installed
    rules: it returns ``x``, with or without a mesh (module docstring)."""
    return x


def batch_axes_for(global_batch: int, mesh) -> Tuple[str, ...]:
    """Axes of ('pod','data') that evenly divide the global batch."""
    picked = []
    size = 1
    for ax in ("pod", "data"):
        if ax in mesh.axis_names and global_batch % (size * mesh.shape[ax]) == 0:
            picked.append(ax)
            size *= mesh.shape[ax]
    return tuple(picked)


def decode_cache_rules(global_batch: int, seq_len: int, mesh) -> Dict:
    """Rules override for decode.

    Batched decode: batch over (pod, data); the cache's KV-head dim (or
    head_dim when KV heads don't divide) takes 'model'.  A cache update on a
    head-sharded layout is a plain in-place update; updating a
    *sequence*-sharded cache lowers to a full-buffer masked select.

    Long-context decode (batch 1): capacity forces context parallelism —
    the sequence dim absorbs every axis, and attention's softmax reductions
    become all-reduces (flash-decoding)."""
    baxes = batch_axes_for(global_batch, mesh)
    rest = [ax for ax in ("pod", "data", "model")
            if ax in mesh.axis_names and ax not in baxes]
    if baxes:
        # spec_for falls back per-dim on divisibility: KV heads first, then
        # head_dim; kv_seq stays unsharded.
        return {"batch": baxes, "kv_seq": (),
                "kv_heads": tuple(rest), "head_dim": tuple(rest)}
    kv_axes = []
    size = 1
    for ax in rest:
        if seq_len % (size * mesh.shape[ax]) == 0:
            kv_axes.append(ax)
            size *= mesh.shape[ax]
    return {"batch": baxes, "kv_seq": tuple(kv_axes)}
