"""Model-zoo tracing — the EDAN method on the model zoo, a port of the
reference package's ``models/tracing.py`` on the PyTorch-graph frontend
(``core/fxgraph.py``).

``trace_model`` turns a model-zoo config (``configs``) and phase (prefill /
decode / train) into a finalized eDAG from ``meta`` inputs only
(``ModelApi.input_specs``, ``abstract`` and ``cache_specs``): no tensor is
allocated and no kernel runs, on any device — a ``meta`` tensor takes the
models' plain paths (``kernels/ops.py``), which is what the reference
traces.  Prefill and decode are captured by ``fxgraph.capture``
(``torch.export``); the train phase, the gradient of ``loss_fn``
(``module.value_and_grad``), by ``make_fx(..., tracing_mode="fake")`` and
then ``make_fx`` of that graph functionalized (``_capture_grad``), since
``torch.export`` cannot take the gradient and ``functionalize`` cannot
take the rematerialised blocks (``remat.py``).  ``trace_train_step``
captures the framework's whole train step (loss, gradient and AdamW
update) the same way.  ``trace_zoo`` builds
one trace per family for ``EDagSuite`` union grids, ``model_grid_report``
runs one ``suite_grid_report`` over them, and ``model_objects`` recovers
placement objects from the vertices' labels for
``core.placement.search_placement``.

Traced graphs dedup through the digest-addressed trace store
(``$EDAN_TRACE_STORE``): a sidecar index maps the request key (config,
phase, shapes, thresholds and ``torch=<version>`` where the reference
writes ``jax=``, so the two packages never share an index entry) to the
trace digest, and a warm store never re-traces.  Stored traces carry no
labels; ``model_objects`` needs a fresh trace (``use_store=False``).

The eDAGs differ from the reference's where the two frameworks decompose
the models differently (ROADMAP §C 15): the embedding is a gather, not the
reference's one-hot contraction; ``torch.export`` keeps a multi-operand
einsum as one node where ``jnp.einsum`` makes pairwise ``dot_general``\\ s;
the encoder-decoder's prefill computes the cross K/V once; a decode
step's position is a constant of the trace.  The train capture keeps the
reference's rematerialisation: each block's forward runs again in the
backward.  ``model_summary`` is the counterpart of the
reference's ``model_hlo_summary``: the same keys, from
``torch.utils.flop_counter`` and the eDAG, not from compiled HLO.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..core.fxgraph import capture, edag_from_fn, edag_from_graph
from ..core.graph import EDag
from ..core.placement import PlacementObject
from ..core.suite import EDagSuite
from ..core.trace_store import get_trace, put_trace, trace_store_dir
from . import get_model
from .module import abstract_params, value_and_grad

PHASES = ("prefill", "decode", "train")

#: Smallest config per family — the default model-zoo grid row set.
ZOO = {
    "dense": "qwen3-0.6b",
    "moe": "granite-moe-1b-a400m",
    "ssm": "rwkv6-7b",
    "hybrid": "zamba2-7b",
    "encdec": "seamless-m4t-large-v2",
    "vlm": "internvl2-2b",
}

#: Arrays above this are memory-access vertices (the cache stand-in), as
#: in the reference.
DEFAULT_MEM_THRESHOLD = 4096.0
DEFAULT_UNROLL = 64
_INDEX_NAME = "model_traces.json"


def _phase_fn(api, phase: str, seq_len: int, batch_size: int):
    """(fn, meta args) for one phase of a model, straight from the model's
    own spec tables."""
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}; choose from {PHASES}")
    shape = ShapeConfig("trace", seq_len, batch_size, phase)
    batch = api.input_specs(shape)
    params = api.abstract()
    if phase == "prefill":
        return (lambda p, b: api.prefill_fn(p, b, cache_len=seq_len),
                (params, batch))
    if phase == "decode":
        cache = abstract_params(api.cache_specs(shape))
        return (lambda p, c, b: api.decode_fn(p, c, b),
                (params, cache, batch))
    grad = value_and_grad(api.loss_fn)
    return (lambda p, b: grad(p, b)[1], (params, batch))


def _capture(phase: str, fn, args) -> torch.fx.GraphModule:
    """The functional ATen graph of one phase: ``torch.export`` for
    prefill and decode, ``_capture_grad`` for train."""
    if phase != "train":
        return capture(fn, *args)
    return _capture_grad(fn, args)


def _capture_grad(fn, args) -> torch.fx.GraphModule:
    """The functional ATen graph of a function that takes a gradient:
    ``make_fx`` of it, then ``make_fx`` of that graph functionalized.
    ``functionalize`` cannot take the rematerialised blocks'
    ``autograd.Function`` (``remat.py``), but the first capture has
    decomposed them into their forward, recompute and backward ops, so
    the recompute stays in the graph."""
    from torch.fx.experimental.proxy_tensor import make_fx
    gm = make_fx(fn, tracing_mode="fake")(*args)
    return make_fx(torch.func.functionalize(gm), tracing_mode="fake")(*args)


def _trace_key(name: str, phase: str, seq_len: int, batch_size: int,
               reduced: bool, thresh: float, unroll: int) -> str:
    return "|".join([name, phase, str(seq_len), str(batch_size),
                     str(bool(reduced)), repr(float(thresh)), str(unroll),
                     f"torch={torch.__version__}"])


def _index_load(path) -> Dict[str, str]:
    try:
        with open(path) as f:
            idx = json.load(f)
        return idx if isinstance(idx, dict) else {}
    except (OSError, ValueError):
        return {}


def _index_update(path, key: str, digest: str) -> None:
    idx = _index_load(path)
    idx[key] = digest
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(idx, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _api(name: Union[str, ModelConfig], reduced: bool):
    if isinstance(name, ModelConfig):
        return get_model(name)
    cfg = get_config(name)
    return get_model(cfg.reduced() if reduced else cfg)


def trace_model(name: Union[str, ModelConfig], phase: str = "prefill", *,
                seq_len: int = 32, batch_size: int = 2,
                reduced: bool = True,
                mem_threshold_bytes: float = DEFAULT_MEM_THRESHOLD,
                scan_unroll_limit: int = DEFAULT_UNROLL,
                use_store: bool = True) -> EDag:
    """Trace one model-zoo config and phase to a finalized eDAG.

    ``reduced=True`` (default) uses the config's smoke-size reduction: the
    same family and topology, small tensors.  A ``ModelConfig`` in place
    of the name is traced as it is (``reduced`` does not apply).  With a
    trace store configured, a repeat request is served from the
    digest-addressed store through the request-key index (stored traces
    carry no labels; pass ``use_store=False`` where labels are needed, as
    ``model_objects`` needs them)."""
    store = trace_store_dir() if use_store else None
    key = _trace_key(name if isinstance(name, str) else repr(name), phase,
                     seq_len, batch_size, reduced, mem_threshold_bytes,
                     scan_unroll_limit)
    if store is not None:
        digest = _index_load(store / _INDEX_NAME).get(key)
        if digest:
            hit = get_trace(digest)
            if hit is not None:
                return hit
    fn, args = _phase_fn(_api(name, reduced), phase, seq_len, batch_size)
    g = edag_from_graph(_capture(phase, fn, args),
                        mem_threshold_bytes=mem_threshold_bytes,
                        scan_unroll_limit=scan_unroll_limit)
    dg = g.trace_digest()
    if store is not None:
        if put_trace(g) is not None:
            _index_update(store / _INDEX_NAME, key, dg)
    return g


def trace_train_step(name: str) -> EDag:
    """The eDAG of the framework's own train step (``train.train_loop.
    make_train_step`` under ``TrainConfig()``) on the reduced config, a
    batch of 2 x 32 tokens (the tracing defaults): loss, gradient and
    AdamW update together, captured from ``meta`` inputs as the train
    phase is (``_capture_grad``), so no kernel runs.
    Not stored in the trace store."""
    from ..configs.base import TrainConfig
    from ..train.optimizer import adamw_init
    from ..train.train_loop import make_train_step
    api = _api(name, True)
    step = make_train_step(api, TrainConfig())
    params = api.abstract()
    batch = api.input_specs(ShapeConfig("trace", 32, 2, "train"))
    gm = _capture_grad(step, (params, adamw_init(params), batch))
    return edag_from_graph(gm, mem_threshold_bytes=DEFAULT_MEM_THRESHOLD,
                           scan_unroll_limit=DEFAULT_UNROLL)


def trace_zoo(phase: str = "prefill",
              families: Optional[List[str]] = None,
              **kw) -> Dict[str, EDag]:
    """One trace per family (``ZOO``) for a given phase, name-keyed."""
    fams = list(families) if families is not None else list(ZOO)
    return {ZOO[f]: trace_model(ZOO[f], phase, **kw) for f in fams}


def model_suite(names: List[str], phase: str = "prefill",
                **kw) -> Tuple[EDagSuite, List[str]]:
    """Union suite over the named configs for one phase — the members
    then run as one block-diagonal ``suite_sweep_grid`` pass."""
    traces = [trace_model(n, phase, **kw) for n in names]
    return EDagSuite(traces, names=list(names)), list(names)


def model_grid_report(names: List[str], alphas, phase: str = "prefill",
                      ms=(4,), compute_slots=(0,), *,
                      params=None, simulate_points: bool = False,
                      policy=None, **trace_kw) -> dict:
    """Latency-sensitivity grid over a set of model configs, end to end.

    Traces every named config for ``phase`` (through the warm trace
    store), builds the union suite and runs one
    ``metrics.suite_grid_report`` over the (alpha, m, compute_slots) grid
    under one ``plan.ExecPolicy`` (``policy=`` pins backend, replay dtype,
    chunk budget and cache reuse for the whole pipeline; ``alphas`` may be
    scalar latencies or latency-class vectors).  Extra keyword arguments
    go to ``trace_model``.  Returns the ``suite_grid_report`` dict with
    ``names`` added."""
    from ..core.metrics import CostModelParams, suite_grid_report
    suite, names = model_suite(list(names), phase, **trace_kw)
    rep = suite_grid_report(
        suite, alphas, ms=ms, compute_slots=compute_slots,
        params=params if params is not None else CostModelParams(),
        simulate_points=simulate_points, policy=policy)
    rep["names"] = list(names)
    return rep


def model_objects(g: EDag, min_vertices: int = 1) -> List[PlacementObject]:
    """Placement objects of a model trace: all memory traffic of one
    operation kind (its label) is one object, as in the reference.
    Groups smaller than ``min_vertices`` fold into ``"<other>"``."""
    g._finalize()
    labels = g.labels()
    if not any(labels):
        raise ValueError(
            "eDAG carries no labels (store-loaded trace?); re-trace with "
            "use_store=False to recover placement objects")
    groups: Dict[str, list] = {}
    for v in np.flatnonzero(g.is_mem):
        groups.setdefault(labels[v] or "<anon>", []).append(int(v))
    merged: Dict[str, list] = {}
    for name in sorted(groups):
        vids = groups[name]
        merged.setdefault(
            name if len(vids) >= min_vertices else "<other>", []).extend(vids)
    out = []
    for name in sorted(merged):
        vids = np.asarray(sorted(merged[name]), dtype=np.int64)
        traffic = int(g.nbytes[vids].sum())
        out.append(PlacementObject(name=name, vertices=vids,
                                   nbytes=traffic, traffic=traffic))
    return out


def model_summary(name: str, phase: str = "prefill", *,
                  seq_len: int = 32, batch_size: int = 2,
                  reduced: bool = True) -> Dict[str, float]:
    """The counterpart of the reference's ``model_hlo_summary``, with its
    keys: ``flops`` counted by ``torch.utils.flop_counter.FlopCounterMode``
    over one run of the phase on ``meta`` tensors (contractions and
    attention only, as PyTorch counts them), ``hbm_bytes`` the bytes of
    the eDAG's memory vertices, and ``n_computations`` the graphs of the
    capture (the top graph and its subgraphs).  These are not the
    reference's numbers, which come from compiled HLO."""
    from torch.utils.flop_counter import FlopCounterMode
    fn, args = _phase_fn(_api(name, reduced), phase, seq_len, batch_size)
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    gm = _capture(phase, fn, args)
    g = edag_from_graph(gm, mem_threshold_bytes=DEFAULT_MEM_THRESHOLD)
    g._finalize()
    n_graphs = sum(1 for m in gm.modules()
                   if isinstance(m, torch.fx.GraphModule))
    return {"flops": float(counter.get_total_flops()),
            "hbm_bytes": float(g.nbytes[g.is_mem].sum()),
            "n_computations": float(n_graphs)}


# ------------------------------------------------------------------ components
# Isolated MLP / attention / SSM blocks at matched widths: the per-component
# Eq 1-4 comparison, without whole-model plumbing diluting the structure.

COMPONENTS = ("mlp", "attention", "ssm")


def trace_component(kind: str, *, d_model: int = 256, seq_len: int = 128,
                    batch_size: int = 2, n_heads: int = 4,
                    mem_threshold_bytes: float = DEFAULT_MEM_THRESHOLD,
                    scan_unroll_limit: int = DEFAULT_UNROLL) -> EDag:
    """Trace one isolated block kind at matched width ``d_model``."""
    from . import layers
    from ..kernels import ops as kops
    B, T, d, H = batch_size, seq_len, d_model, n_heads
    hd = d // H

    def meta(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    if kind == "mlp":
        fn = layers.swiglu
        args = (meta(B, T, d), meta(d, 4 * d), meta(d, 4 * d), meta(4 * d, d))
    elif kind == "attention":
        def fn(q, k, v):
            return layers.attention_ref(q, k, v, causal=True, chunk_kv=64)
        args = (meta(B, T, H, hd), meta(B, T, H, hd), meta(B, T, H, hd))
    elif kind == "ssm":
        # mamba2 SSD shapes: x (B,H,T,P); dt (B,H,T); A,D (H,);
        # Bm,Cm (B,G,T,N); state (B,H,P,N)
        N = hd

        def fn(x, dt, A, Bm, Cm, D, S0):
            return kops.ssd(x, dt, A, Bm, Cm, D, S0, chunk=64)
        args = (meta(B, H, T, hd), meta(B, H, T), meta(H),
                meta(B, 1, T, N), meta(B, 1, T, N), meta(H), meta(B, H, hd, N))
    else:
        raise ValueError(f"unknown component {kind!r}; "
                         f"choose from {COMPONENTS}")
    g = edag_from_fn(fn, *args, mem_threshold_bytes=mem_threshold_bytes,
                     scan_unroll_limit=scan_unroll_limit)
    g.trace_digest()
    return g
