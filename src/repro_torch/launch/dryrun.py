"""Multi-pod dry-run of the model zoo on one card's terms, the port of the
reference package's ``launch/dryrun.py``.

The reference lowers and compiles each (arch x shape x mesh) cell's SPMD
step for 256 or 512 fake devices and reads XLA's memory and cost analyses
and the compiled HLO.  The port has no XLA, so each value of the artifact
comes from its own source:

* ``memory_analysis``: the argument, alias and output bytes are the
  per-device shard bytes of the parameters, the optimizer state, the batch
  and the decode cache under ``sharding.rules`` on ``launch/mesh.py``'s
  production meshes, divided as the reference's ``_shard_shape`` divides
  (an output's tuple adds 8 bytes per leaf, as XLA's does);
  ``temp_size_in_bytes`` is XLA's buffer assignment replayed on the
  cell's compiled, scheduled text (``core.hlo.hlo_temp_bytes``) where the
  text is recorded, else the per-device step's estimate: its peak live
  bytes on ``meta`` tensors less the bytes of its inputs (``LiveBytes``),
  which cannot show XLA's sequence parallelism, FSDP or sharded heads.
  The step's estimate is also kept as ``temp_size_in_bytes_step``, and
  ``temp_source`` says which of the two ("hlo" or "step") the temp is.
  ``hbm_per_device_bytes`` is argument + temp + output - alias, less (on
  a decode cell's text) the CPU backend's float32 shadows of the bf16
  caches (``cpu_bf16_shadow_bytes``), as the reference computes it;
* ``cost_analysis``: ``FlopCounterMode``'s FLOPs over the per-device step
  and the sum of every operation's input and output bytes;
* ``collectives``, ``per_axis_lambda``, ``hlo_flops_per_device`` and
  ``hlo_bytes_per_device``: the reference's compiled text of the cell
  (``configs/hlo/dryrun/<arch>__<shape>__<mesh>.hlo.gz``, written by
  ``tools/dryrun_expected.py``) through the port's ``core/hlo.py`` and
  ``core.sensitivity.collective_sensitivity``, whose per-axis depths are
  ``EDag.mem_layers`` passes of the level kernel (K1) on the card; a cell
  or variant without a recorded text leaves them null;
* ``roofline``: the compute, memory and collective seconds on the H100's
  rates (``configs.base.HW``), from the HLO estimates where the text is
  recorded (``source`` "hlo"), else from ``cost_analysis`` with a null
  ``collective_s`` (``source`` "torch").

The per-device step is the model's own step at per-device shapes: every
sharded logical dimension divided by its mesh axes as ``spec_for``
divides it (a dimension that does not divide stays whole), but
``d_model`` whole (FSDP's ``embed`` shard is gathered before use) and
``head_dim`` whole; where the kept kv heads do not divide the local query
heads, as many kv heads as divide them (GQA's grouping); an RWKV6 block's
heads and a Mamba2 block's inner width whole (both derive from
``d_model``); the local vocabulary rounded up to 16.  A train cell takes
the reference's microbatch rule; ``--cast-bf16`` gives the train step a
bf16 compute copy, ``--bf16-params`` stores a serving cell's weights in
bf16.  Sequence parallelism (``seq_res``) is not shown.  On the card's 1x1
mesh, where no text is recorded, the step's temp is the one reported.

Usage:
  python -m repro_torch.launch.dryrun --cell <arch> <shape> <mesh>  # a cell
  python -m repro_torch.launch.dryrun --all [--resume]        # every cell
  python -m repro_torch.launch.dryrun --table     # the roofline report
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import glob
import gzip
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

ARTIFACTS = Path(__file__).resolve().parents[3] / "experiments" / \
    "artifacts_torch"
FIXTURES = Path(__file__).resolve().parents[1] / "configs" / "hlo" / "dryrun"
MESHES = ("pod", "multipod", "host")
_TUPLE_ENTRY_BYTES = 8          # one pointer per leaf of a tuple output


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N_active*tokens (train) / 2*N_active*tokens (fwd)."""
    from ..models import get_model
    n = get_model(cfg).n_params()
    if cfg.n_experts:
        # subtract inactive expert params: 3*d*ff per expert per layer
        expert_p = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts * cfg.n_layers
        n = n - expert_p * (1 - cfg.top_k / cfg.n_experts)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: 1 token per seq


def microbatches(n_params: int, cfg) -> int:
    """The reference's grad-accumulation rule: activation memory scales
    1/mb (MoE counts too: dispatch buffers scale with tokens per
    microbatch)."""
    return 8 if n_params > 20e9 else (4 if (n_params > 1e9 or cfg.n_experts)
                                      else 1)


def make_mesh(mesh_kind):
    """The mesh of a kind ("pod", "multipod", "host"); a mesh object
    (``launch.mesh.Mesh``) is returned as it is."""
    from .mesh import make_host_mesh, make_production_mesh
    if not isinstance(mesh_kind, str):
        return mesh_kind
    if mesh_kind not in MESHES:
        raise ValueError(f"unknown mesh {mesh_kind!r}; choose from {MESHES}")
    if mesh_kind == "host":
        return make_host_mesh()
    return make_production_mesh(multi_pod=(mesh_kind == "multipod"))


# --------------------------------------------------------------- live bytes

class LiveBytes(TorchDispatchMode):
    """Live bytes of ``meta`` tensors over a run, keyed on storages: a storage counts
    from the first operation that returns a tensor on it until the storage
    itself is freed, however many tensors view it and whoever keeps it
    (autograd's saved tensors included).  Liveness is read through a weak
    reference to the storage (``StorageWeakRef``), never through its
    Python object, which each ``untyped_storage()`` call may make anew.
    ``accessed`` sums every operation's input and output bytes and
    ``reads`` holds the storages that some operation took as an input,
    views (which move nothing) left out."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, tuple] = {}
        self.current = self.peak = 0
        self.accessed = 0
        self.reads: set = set()

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage from now on, if it is not counted yet."""
        if t.device.type != "meta":
            return
        st = t.untyped_storage()
        if st._cdata in self.live:
            return
        n = st.nbytes()
        if self.current + n > self.peak:
            # ``current`` counts storages freed since the last sweep; the
            # peak needs the exact count only where it might rise
            self.sweep()
        self.live[st._cdata] = (StorageWeakRef(st), n)
        self.current += n
        self.peak = max(self.peak, self.current)

    def sweep(self) -> None:
        """Drop the storages freed since the last sweep."""
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.current -= self.live.pop(k)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [x for x in pytree.tree_leaves(out)
                if isinstance(x, torch.Tensor)]
        if not func.is_view:            # a view moves and reads nothing
            ins = [x for x in pytree.tree_leaves((args, kwargs))
                   if isinstance(x, torch.Tensor)]
            self.accessed += sum(x.numel() * x.element_size()
                                 for x in ins + outs)
            self.reads.update(x.untyped_storage()._cdata for x in ins
                              if x.device.type == "meta")
        for x in outs:
            self.track(x)
        return out


# ------------------------------------------------------------------- bytes

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, pspec, mesh) -> tuple:
    """The per-device shape under ``pspec``: the reference's
    ``_shard_shape``."""
    dims = list(shape)
    for i, entry in enumerate(pspec):
        for ax in _axes(entry):
            dims[i] //= mesh.shape[ax]
    return tuple(dims)


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _paths(tree, prefix=()):
    """(path, leaf) of nested dicts, keys in the tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _specs_bytes(specs, mesh, rules, prefix, skip=frozenset(),
                 dtype_of=lambda dt: dt) -> tuple:
    """(per-device bytes, leaves) of a ``ParamSpec`` tree, less the leaves
    whose path (under ``prefix``) is in ``skip``."""
    from ..sharding.rules import spec_for
    total, n = 0, 0
    for path, s in _paths(specs, prefix):
        if path in skip:
            continue
        total += _nbytes(shard_shape(s.shape, spec_for(s.shape, s.logical,
                                                       mesh, rules), mesh),
                         dtype_of(s.dtype))
        n += 1
    return total, n


def input_logical(cfg, kind: str) -> dict:
    """The logical axes of a batch's leaves (the reference's
    ``input_specs`` pairs them with the ShapeDtypeStructs)."""
    if kind == "decode":
        return {"tokens": ("batch", None), "cur_index": ()}
    out = {"tokens": ("batch", "seq")}
    if kind == "train":
        out["labels"] = ("batch", "seq")
    if cfg.family == "encdec":
        out["frame_embeds"] = ("batch", "seq", None)
    elif cfg.family == "vlm":
        out["prefix_embeds"] = ("batch", "seq", None)
    return out


def _batch_bytes(api, shape, mesh, rules, skip=frozenset()) -> int:
    from ..sharding.rules import spec_for
    logical = input_logical(api.cfg, shape.kind)
    total = 0
    for k, x in api.input_specs(shape).items():
        if ("batch", k) in skip:
            continue
        if not isinstance(x, torch.Tensor):          # decode's cur_index
            total += torch.int32.itemsize
            continue
        sp = spec_for(x.shape, logical[k], mesh, rules)
        total += _nbytes(shard_shape(x.shape, sp, mesh), x.dtype)
    return total


def memory_bytes(api, shape, mesh, rules, bf16_params: bool = False,
                 unused=frozenset()) -> dict:
    """XLA's ``argument``, ``alias`` and ``output`` sizes of the cell's
    step, from the shard bytes of its inputs and outputs (module
    docstring).  ``unused`` (``unused_inputs``) are the paths of inputs
    the step never reads, which jax's ``jit`` drops from the module."""
    from ..sharding.rules import spec_for
    serve_bf16 = bf16_params and shape.kind != "train"
    pdt = (lambda dt: torch.bfloat16 if dt == torch.float32 else dt) \
        if serve_bf16 else (lambda dt: dt)
    params, n_params = _specs_bytes(api.specs(), mesh, rules, ("params",),
                                    unused, pdt)
    batch = _batch_bytes(api, shape, mesh, rules, unused)
    if shape.kind == "train":
        f32 = lambda dt: torch.float32          # noqa: E731
        moment, _ = _specs_bytes(api.specs(), mesh, rules, ("params",),
                                 unused, f32)
        state = params + 2 * moment + torch.int32.itemsize      # + step
        n_out = 3 * n_params + 1 + 3        # params, mu, nu, step, metrics
        return {"argument_size_in_bytes": state + batch,
                "alias_size_in_bytes": state,
                "output_size_in_bytes": state + 3 * 4 +
                _TUPLE_ENTRY_BYTES * n_out}
    c = api.cfg
    V = c.padded_vocab()
    B = shape.global_batch
    # the last token's logits: the reference's prefill module keeps them
    # sharded over the batch only, its decode module over the vocabulary
    # too
    logical = ("batch", None) if shape.kind == "prefill" else \
        ("batch", "vocab")
    logits = _nbytes(shard_shape((B, V), spec_for((B, V), logical, mesh,
                                                  rules), mesh),
                     torch.float32)
    cache, n_cache = _specs_bytes(api.cache_specs(shape), mesh, rules,
                                  ("cache",))
    out = logits + cache + _TUPLE_ENTRY_BYTES * (1 + n_cache)
    if shape.kind == "prefill":
        return {"argument_size_in_bytes": params + batch,
                "alias_size_in_bytes": 0, "output_size_in_bytes": out}
    read, _ = _specs_bytes(api.cache_specs(shape), mesh, rules, ("cache",),
                           unused)
    return {"argument_size_in_bytes": params + read + batch,
            "alias_size_in_bytes": read, "output_size_in_bytes": out}


# ------------------------------------------------------ the per-device step

def _divisor(logical: str, n: int, mesh, rules) -> int:
    from ..sharding.rules import spec_for
    sp = spec_for((n,), (logical,), mesh, rules)
    return math.prod(mesh.shape[ax] for ax in _axes(sp[0])) if sp else 1


def per_device(cfg, shape, mesh, rules) -> tuple:
    """(config, shape) of one device's share of the cell's step (module
    docstring)."""
    from ..configs.base import ShapeConfig
    div = lambda name, n: n // _divisor(name, n, mesh, rules) \
        if n else n                                          # noqa: E731
    H = cfg.padded_heads if cfg.family == "ssm" else \
        div("heads", cfg.padded_heads)
    KV = div("kv_heads", cfg.n_kv_heads)
    if KV and H % KV:
        KV = math.gcd(H, KV)
    E = div("expert", cfg.n_experts)
    V = -(-cfg.padded_vocab() // _divisor("vocab", cfg.padded_vocab(),
                                           mesh, rules))
    local = dataclasses.replace(
        cfg, n_heads=H, n_kv_heads=KV, head_dim=cfg.hd, head_pad_to=0,
        d_ff=div("mlp", cfg.d_ff), vocab_size=V, n_experts=E,
        top_k=min(cfg.top_k, E))
    S = shape.seq_len
    if shape.kind == "decode":
        S = div("kv_seq", S)
    return local, ShapeConfig(shape.name, S, div("batch", shape.global_batch),
                              shape.kind)


class _Position(int):
    """A decode step's position that records whether the step read it."""
    read = False

    def __int__(self):
        self.read = True
        return int.__int__(self)

    __index__ = __int__


def _step_inputs(local, lshape, train, bf16_params: bool) -> tuple:
    """(inputs by name, the step as a function of no arguments)."""
    from ..models import get_model
    from ..models.module import abstract_params, tree_map
    from ..train.optimizer import adamw_init
    from ..train.train_loop import make_train_step
    api = get_model(local)
    params = api.abstract()
    if bf16_params and lshape.kind != "train":
        params = tree_map(lambda x: x.to(torch.bfloat16)
                          if x.dtype == torch.float32 else x, params)
    batch = api.input_specs(lshape)
    if lshape.kind == "train":
        step = make_train_step(api, train)
        state = adamw_init(params)
        return ({"params": params, "state": state, "batch": batch},
                lambda: step(params, state, batch))
    if lshape.kind == "prefill":
        return ({"params": params, "batch": batch},
                lambda: api.prefill_fn(params, batch,
                                       cache_len=lshape.seq_len))
    batch["cur_index"] = _Position(batch["cur_index"])
    cache = abstract_params(api.cache_specs(lshape))
    return ({"params": params, "cache": cache, "batch": batch},
            lambda: api.decode_fn(params, cache, batch))


@functools.lru_cache(maxsize=None)
def unused_inputs(cfg, kind: str) -> frozenset:
    """Paths (``("params", ...)``, ``("cache", ...)``, ``("batch",
    key)``) of the inputs that a ``kind`` step of ``cfg``'s family never
    reads, found by running the family's reduced config on ``meta``
    tensors: an RWKV6 decode step never reads its position, an
    encoder-decoder's decode step no encoder weight."""
    from ..configs.base import ShapeConfig, TrainConfig
    inputs, run = _step_inputs(cfg.reduced(), ShapeConfig("usage", 16, 2,
                                                         kind),
                               TrainConfig(), False)
    meter = LiveBytes()
    with meter:
        run()
    out = set()
    for (name, tree) in inputs.items():
        if not isinstance(tree, dict):              # the optimizer state
            continue
        for path, x in _paths(tree, (name,)):
            if isinstance(x, _Position):
                unread = not x.read
            else:
                unread = x.untyped_storage()._cdata not in meter.reads
            if unread:
                out.add(path)
    return frozenset(out)


def per_device_step(cfg, shape, mesh, rules, cast_bf16: bool = False,
                    bf16_params: bool = False, n_params: int = 0) -> dict:
    """Run the cell's per-device step on ``meta`` tensors: its FLOPs
    (``FlopCounterMode``), bytes accessed, the bytes of its inputs, the
    peak of its live bytes (``LiveBytes``) and ``temp_bytes``, the peak
    less the inputs."""
    from torch.utils.flop_counter import FlopCounterMode
    from ..configs.base import TrainConfig
    from ..models import get_model
    local, lshape = per_device(cfg, shape, mesh, rules)
    train = None
    if shape.kind == "train":
        mb = microbatches(n_params or get_model(cfg).n_params(), cfg)
        train = TrainConfig(microbatches=mb, cast_params_bf16=cast_bf16)
    inputs, run = _step_inputs(local, lshape, train, bf16_params)
    meter = LiveBytes()
    for x in pytree.tree_leaves(inputs):
        if isinstance(x, torch.Tensor):
            meter.track(x)
    before = meter.current
    with FlopCounterMode(display=False) as flops, meter:
        run()
    out = {"flops": int(flops.get_total_flops()),
           "bytes_accessed": meter.accessed, "input_bytes": before,
           "peak_bytes": meter.peak, "temp_bytes": meter.peak - before}
    out["per_device"] = {"n_heads": local.n_heads,
                         "n_kv_heads": local.n_kv_heads,
                         "d_ff": local.d_ff, "vocab": local.vocab_size,
                         "n_experts": local.n_experts,
                         "batch": lshape.global_batch,
                         "seq_len": lshape.seq_len,
                         "microbatches": train.microbatches if train else 1}
    return out


# ----------------------------------------------------------------- the cell

def cell_name(arch: str, shape: str, mesh: str) -> str:
    return f"{arch}__{shape}__{mesh}"


def cell_path(out_dir, arch, shape, mesh):
    return os.path.join(out_dir, f"{cell_name(arch, shape, mesh)}.json")


def fixture_text(arch: str, shape_name: str, mesh_kind: str) -> Optional[str]:
    """The reference's compiled text of the cell, or None."""
    path = FIXTURES / f"{cell_name(arch, shape_name, mesh_kind)}.hlo.gz"
    if not path.exists():
        return None
    return gzip.decompress(path.read_bytes()).decode()


def cpu_bf16_shadow_bytes(text: str, api, shape, mesh, rules) -> int:
    """The reference's ``bf16_shadow_bytes``: on a decode cell's text, the
    bytes of the float32 copies the CPU backend makes of bf16 cache leaves
    (a ``convert`` to f32 at exactly a leaf's per-device shard shape),
    which a TPU does not make."""
    import re
    from ..sharding.rules import spec_for
    if shape.kind != "decode":
        return 0
    total = 0
    for _, s in _paths(api.cache_specs(shape)):
        if s.dtype != torch.bfloat16:
            continue
        shard = shard_shape(s.shape, spec_for(s.shape, s.logical, mesh,
                                              rules), mesh)
        pat = re.escape("f32[" + ",".join(map(str, shard)) + "]")
        if re.search(r"= " + pat + r"\{[^}]*\} convert\(", text):
            total += math.prod(shard) * 4
    return total


def hlo_analysis(text: str, axes) -> dict:
    """The HLO frontend's values of a compiled text (``core/hlo.py``,
    ``collective_sensitivity``; K1 on the selected backend)."""
    from ..core.hlo import (analyze_collectives, hlo_flops_estimate,
                            hlo_hbm_bytes_estimate)
    from ..core.sensitivity import collective_sensitivity
    sens = collective_sensitivity(text, axes)
    return {"hlo_flops_per_device": hlo_flops_estimate(text),
            "hlo_bytes_per_device": hlo_hbm_bytes_estimate(text),
            "collectives": analyze_collectives(text, axes),
            "per_axis_lambda": {ax: s.row()
                                for ax, s in sens["per_axis"].items()}}


def roofline(flops: float, nbytes: float, coll_bytes: Optional[float],
             source: str) -> dict:
    """Compute, memory and collective seconds on ``HW``'s rates and the
    largest of them."""
    from ..configs.base import HW
    terms = {"compute": flops / HW["peak_flops_bf16"],
             "memory": nbytes / HW["hbm_bw"],
             "collective": (None if coll_bytes is None else
                            coll_bytes / HW["nvlink_bw_per_gpu"])}
    return {"compute_s": terms["compute"], "memory_s": terms["memory"],
            "collective_s": terms["collective"],
            "dominant": max((k for k, v in terms.items() if v is not None),
                            key=lambda k: terms[k]),
            "source": source}


def run_cell(arch: str, shape_name, mesh_kind: str, out_dir: str = None,
             overrides=None, cast_bf16: bool = False,
             bf16_params: bool = False, hlo_text: Optional[str] = None,
             step: bool = True):
    """One cell's artifact (module docstring).  ``shape_name`` is a key of
    ``SHAPES`` or a ``ShapeConfig``; ``mesh_kind`` "pod", "multipod",
    "host" (the card's 1x1 mesh) or a ``launch.mesh.Mesh``; ``out_dir``
    is not read (``main`` writes the artifact).  The reference's compiled
    text of the cell is read from the fixtures unless ``hlo_text`` is
    given; a variant (``overrides``, ``cast_bf16``, ``bf16_params``) reads
    none.  ``step=False`` skips the per-device step (a train cell's takes
    seconds to minutes on the host): ``cost_analysis`` and
    ``temp_size_in_bytes_step`` are then null, and the cell needs the
    compiled text, which gives the temp and the roofline."""
    from ..configs import ARCHS, SHAPES, HW, shape_applicable
    from ..launch.mesh import mesh_axis_sizes
    from ..models import get_model
    from ..sharding.rules import DEFAULT_RULES, decode_cache_rules

    cfg = ARCHS[arch]
    if overrides:
        typed = {}
        for k, v in overrides.items():
            ft = type(getattr(cfg, k))
            typed[k] = (v.lower() in ("1", "true") if ft is bool else ft(v))
        cfg = dataclasses.replace(cfg, **typed)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if not shape_applicable(arch, shape):
        return {"skipped": "full-attention arch at long_500k (DESIGN.md §4)"}
    mesh = make_mesh(mesh_kind)
    axes = mesh_axis_sizes(mesh)
    api = get_model(cfg)
    rules = dict(DEFAULT_RULES)
    rules.update(api.rules_override())
    if shape.kind == "decode":
        rules.update(decode_cache_rules(shape.global_batch, shape.seq_len,
                                        mesh))
    n_dev = math.prod(mesh.shape.values())
    n_params = api.n_params()

    variant = bool(overrides) or cast_bf16 or bf16_params
    if hlo_text is None and not variant and isinstance(shape_name, str) \
            and isinstance(mesh_kind, str):
        hlo_text = fixture_text(arch, shape_name, mesh_kind)

    t0 = time.time()
    mem = memory_bytes(api, shape, mesh, rules, bf16_params,
                       unused_inputs(cfg, shape.kind))
    mem["generated_code_size_in_bytes"] = 0
    if step:
        st = per_device_step(cfg, shape, mesh, rules, cast_bf16, bf16_params,
                             n_params)
        cost = {"flops": float(st["flops"]),
                "bytes accessed": float(st["bytes_accessed"])}
    else:
        st, cost = None, None
    mem["temp_size_in_bytes_step"] = None if st is None else st["temp_bytes"]
    t_step = time.time() - t0

    t0 = time.time()
    shadow = 0
    if hlo_text is not None:
        from ..core.hlo import hlo_temp_bytes
        mem["temp_size_in_bytes"] = hlo_temp_bytes(hlo_text)
        mem["temp_source"] = "hlo"
        shadow = cpu_bf16_shadow_bytes(hlo_text, api, shape, mesh, rules)
        hlo = hlo_analysis(hlo_text, axes)
        flops_dev = hlo["hlo_flops_per_device"]
        roof = roofline(flops_dev, hlo["hlo_bytes_per_device"],
                        hlo["collectives"]["total"]["bytes"], "hlo")
    elif cost is not None:
        mem["temp_size_in_bytes"] = st["temp_bytes"]
        mem["temp_source"] = "step"
        hlo = {"hlo_flops_per_device": None, "hlo_bytes_per_device": None,
               "collectives": None, "per_axis_lambda": None}
        flops_dev = cost["flops"]
        roof = roofline(flops_dev, cost["bytes accessed"], None, "torch")
    else:
        raise ValueError(f"{arch} {shape.name} {mesh_kind}: no compiled "
                         f"text to read and no per-device step to run")
    t_hlo = time.time() - t0

    mf = model_flops(cfg, shape)
    # donated inputs alias their outputs: count them once
    raw = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] +
           mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
    hbm = raw - shadow
    return {
        "arch": arch, "shape": shape.name,
        "mesh": mesh_kind if isinstance(mesh_kind, str) else "custom",
        "n_devices": n_dev,
        "t_step_s": round(t_step, 2), "t_hlo_s": round(t_hlo, 2),
        "memory_analysis": mem,
        "hbm_per_device_bytes": hbm,
        "hbm_per_device_bytes_cpu_backend": raw,
        "cpu_bf16_shadow_bytes": shadow,
        "fits_hbm": hbm <= HW["hbm_bytes"],
        "cost_analysis": cost,
        **hlo,
        "roofline": roof,
        "model_flops_global": mf,
        "model_flops_per_device": mf / n_dev,
        "useful_flops_ratio": (mf / n_dev) / flops_dev if flops_dev else None,
        "per_device_step": None if st is None else {
            k: st[k] for k in ("input_bytes", "peak_bytes", "per_device")},
    }


# ------------------------------------------------------------------ report

def load_cells(out_dir, mesh: str = None) -> list:
    cells = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            d = json.load(f)
        if "skipped" in d or "error" in d:
            continue
        if mesh and d["mesh"] != mesh:
            continue
        cells.append(d)
    return cells


def roofline_fraction(d) -> float:
    """compute term / the largest term: 1.0 is compute-bound."""
    r = d["roofline"]
    top = max(r["compute_s"], r["memory_s"], r["collective_s"] or 0.0,
              1e-12)
    return r["compute_s"] / top


def table(out_dir) -> list:
    """The roofline report of ``benchmarks/roofline.py`` over the port's
    artifacts: one CSV row per cell, on the H100's rates."""
    cells = load_cells(out_dir)
    if not cells:
        return ["# no dry-run artifacts; run: python -m "
                "repro_torch.launch.dryrun --all"]
    rows = ["arch,shape,mesh,fits,compute_s,memory_s,collective_s,"
            "dominant,source,useful_flops_ratio,lam_model,lam_data,lam_pod,"
            "hbm_GiB"]
    for d in cells:
        r = d["roofline"]
        lam = {ax: v["lam"] for ax, v in
               (d.get("per_axis_lambda") or {}).items()}
        coll = "" if r["collective_s"] is None else f"{r['collective_s']:.4g}"
        rows.append(f"{d['arch']},{d['shape']},{d['mesh']},"
                    f"{int(bool(d['fits_hbm']))},{r['compute_s']:.4g},"
                    f"{r['memory_s']:.4g},{coll},{r['dominant']},"
                    f"{r['source']},{(d.get('useful_flops_ratio') or 0):.3f},"
                    f"{lam.get('model', 0):.0f},{lam.get('data', 0):.0f},"
                    f"{lam.get('pod', 0):.0f},"
                    f"{(d['hbm_per_device_bytes'] or 0) / 2**30:.1f}")
    pod = [d for d in cells if d["mesh"] == "pod"]
    if pod:
        worst = min(pod, key=roofline_fraction)
        rows.append(f"# worst roofline fraction: {worst['arch']}/"
                    f"{worst['shape']} ({roofline_fraction(worst):.3f})")
    return rows


# -------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", nargs=3, metavar=("ARCH", "SHAPE", "MESH"))
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", help="ModelConfig field override")
    ap.add_argument("--cast-bf16", action="store_true",
                    help="train: bf16 compute copy of the params")
    ap.add_argument("--bf16-params", action="store_true",
                    help="serve: store params in bf16")
    ap.add_argument("--tag", default="",
                    help="artifact filename suffix for variants")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--mesh", default=None, choices=["pod", "multipod"])
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--table", action="store_true",
                    help="print the roofline report of --out's artifacts")
    args = ap.parse_args(argv)

    if args.table:
        print("\n".join(table(args.out)))
        return 0
    os.makedirs(args.out, exist_ok=True)
    if args.cell:
        arch, shape, mesh = args.cell
        overrides = dict(kv.split("=", 1) for kv in args.set)
        try:
            res = run_cell(arch, shape, mesh, args.out, overrides=overrides,
                           cast_bf16=args.cast_bf16,
                           bf16_params=args.bf16_params)
            res["variant"] = {"set": overrides, "cast_bf16": args.cast_bf16,
                              "bf16_params": args.bf16_params,
                              "tag": args.tag}
            status = "skip" if "skipped" in res else "ok"
        except Exception as e:                  # recorded in the artifact
            res = {"arch": arch, "shape": shape, "mesh": mesh,
                   "error": repr(e), "traceback": traceback.format_exc()}
            status = "error"
        path = cell_path(args.out, arch, shape, mesh)
        if args.tag:
            path = path.replace(".json", f"__{args.tag}.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=1, default=str)
        print(f"[{status}] {arch} {shape} {mesh}")
        return 0 if status != "error" else 1
    if not args.all:
        ap.error("give --cell ARCH SHAPE MESH, --all or --table")

    # orchestrator: one subprocess per cell (bounded memory, resumable)
    from ..configs import ARCHS, SHAPES
    cells = [(a, s, m) for a in ARCHS for s in SHAPES
             for m in ("pod", "multipod")]
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.mesh:
        cells = [c for c in cells if c[2] == args.mesh]
    todo = [c for c in cells
            if not (args.resume and os.path.exists(cell_path(args.out, *c)))]
    print(f"dry-run: {len(todo)} cells to run "
          f"({len(cells) - len(todo)} cached)")
    failures = 0
    for i, (a, s, m) in enumerate(todo):
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--cell", a, s, m, "--out", args.out],
            capture_output=True, text=True)
        tail = (r.stdout + r.stderr).strip().splitlines()
        print(f"[{i + 1}/{len(todo)}] {a} {s} {m}: "
              f"{tail[-1] if tail else ''} ({time.time() - t0:.0f}s)",
              flush=True)
        failures += r.returncode != 0
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
