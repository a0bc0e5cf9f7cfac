"""The port's model-zoo tracing (``repro_torch.models.tracing``) on the CPU,
against the reference package's (``tests/test_model_tracing.py``'s cases,
less its ``PINS``: they pin the reference's own jaxpr traces, which are
not ground truth for the port, ROADMAP §C 2).

* Each family and phase traces from ``meta`` inputs to the eDAG recorded
  in ``configs/zoo_expected.json`` (``tools/zoo_expected.py``), digest
  stable on re-tracing, W > D; ``meta`` and CPU inputs give one eDAG.
* ``dot_general`` FLOPs equal the reference trace's less named
  differences, each asserted by its cause (``named_gap``): the one-hot
  embedding contraction (the port gathers), the recurrences' multi-operand
  einsums (``jnp.einsum`` makes pairwise ``dot_general``\\ s, ``torch.export``
  one node; measured by tracing the chunked recurrence alone in both
  frontends), the encoder-decoder prefill's second cross K/V (the port
  computes it once) and, in the train phase, the recompute's dead products
  (both packages rematerialise each block and attention chunk; the
  reference's dead-code elimination drops the recomputed products whose
  output the backward does not read, the port's recompute runs them).
* The train trace is more than twice the prefill trace.
* Model grids: the port's union suite against solo grids bit for bit
  (the reference's property test), and the port's eDAGs analysed alike,
  bit for bit, by both packages; ``model_grid_report`` equal to the
  fixture's JAX-package values.
* The trace store's dedup, ``model_objects`` feeding ``search_placement``,
  the component traces and ``model_summary`` (the counterpart of
  ``model_hlo_summary``).
"""
import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as R
from repro.models import tracing as RT
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import grid_report, report, suite_grid_report
from repro_torch.core.placement import search_placement
from repro_torch.core.suite import EDagSuite
from repro_torch.models import get_model, mamba2
from repro_torch.models import tracing
from repro_torch.models.module import tree_map

EXPECTED = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "configs" / "zoo_expected.json"
NAMES = sorted(tracing.ZOO.values())
B, T = 2, 32                       # trace_model's batch and seq_len


@pytest.fixture(autouse=True)
def _on_the_host(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")
    monkeypatch.delenv("EDAN_TRACE_STORE", raising=False)


_TRACE_MODEL = tracing.trace_model


@functools.lru_cache(maxsize=None)
def port_trace(name, phase):
    return _TRACE_MODEL(name, phase, use_store=False)


@functools.lru_cache(maxsize=None)
def ref_trace(name, phase, remat=True):
    if remat:
        return RT.trace_model(name, phase, use_store=False)
    saved = jax.checkpoint
    jax.checkpoint = lambda f, *a, **kw: f
    try:
        return RT.trace_model(name, phase, use_store=False)
    finally:
        jax.checkpoint = saved


@functools.lru_cache(maxsize=None)
def expected():
    return json.loads(EXPECTED.read_text())


def dot_flops(g) -> float:
    g._finalize()
    labels = g.labels()
    return float(sum(c for c, lab in zip(np.asarray(g.cost), labels)
                     if lab == "dot_general"))


# ------------------------------------------------------------ the zoo's shape

def test_zoo_covers_every_family_once():
    assert tracing.ZOO == RT.ZOO
    assert tracing.PHASES == RT.PHASES
    assert tracing.COMPONENTS == RT.COMPONENTS
    assert (tracing.DEFAULT_MEM_THRESHOLD, tracing.DEFAULT_UNROLL) == \
        (RT.DEFAULT_MEM_THRESHOLD, RT.DEFAULT_UNROLL)
    assert sorted(tracing.ZOO) == ["dense", "encdec", "hybrid", "moe",
                                   "ssm", "vlm"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_family_shape_and_digest_pinned(name, phase):
    """The recorded eDAG (the fixture), digest-stable on re-tracing, with
    real memory parallelism: W above D (a collapsed opaque trace
    degenerates to a chain, W == D), W the memory vertices."""
    g = port_trace(name, phase)
    want = expected()["port_traces"][f"{name}:{phase}"]
    dg = g.trace_digest()
    assert (g.n_vertices, g.n_edges, int(g.is_mem.sum())) == \
        (want["vertices"], want["edges"], want["mem_vertices"])
    assert dg == want["digest"] and len(dg) == 64
    assert tracing.trace_model(name, phase,
                               use_store=False).trace_digest() == dg
    r = report(g)
    assert r.W == want["mem_vertices"]
    assert r.D < r.W


# ------------------------------------------------------- named differences

def recurrence_gap(cfg, phase: str) -> float:
    """The reference's chunked recurrence's ``dot_general`` FLOPs less the
    port's, each traced alone in its own frontend at the model's shapes:
    forward (prefill T=32, decode T=1), or for train the gradient of the
    outputs' sum with respect to every input but the zero initial state."""
    from repro.core.jaxpr import edag_from_fn as jax_edag
    from repro.kernels import ref as rref
    from repro_torch.core.fxgraph import edag_from_fn, edag_from_graph
    from repro_torch.kernels import ref as pref
    steps = 1 if phase == "decode" else T
    if cfg.family == "ssm":
        H, K = cfg.n_heads, cfg.hd
        shapes = [(B, H, steps, K)] * 4 + [(H, K), (B, H, K, K)]
        jfn, pfn = rref.wkv6_chunked_ref, pref.wkv6_chunked_ref
    else:
        _, H, P, N, G = mamba2.dims(cfg)
        shapes = [(B, H, steps, P), (B, H, steps), (H,), (B, G, steps, N),
                  (B, G, steps, N), (H,), (B, H, P, N)]
        jfn, pfn = rref.ssd_chunked_ref, pref.ssd_chunked_ref
    sds = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    meta = [torch.empty(s, device="meta") for s in shapes]
    chunk = cfg.ssm_chunk
    if phase != "train":
        jg = jax_edag(lambda *a: jfn(*a, chunk=chunk), *sds)
        pg = edag_from_fn(lambda *a: pfn(*a, chunk=chunk), *meta)
        return dot_flops(jg) - dot_flops(pg)
    from torch.fx.experimental.proxy_tensor import make_fx
    argnums = tuple(range(len(shapes) - 1))

    def jloss(*a):
        return jfn(*a[:-1], jnp.zeros(shapes[-1]), chunk=chunk)[0].sum()

    def ploss(*a):
        return pfn(*a[:-1], torch.zeros(shapes[-1], device=a[0].device),
                   chunk=chunk)[0].sum()
    jg = jax_edag(jax.grad(jloss, argnums=argnums), *sds)
    grad = torch.func.grad(ploss, argnums=argnums)
    pg = edag_from_graph(make_fx(torch.func.functionalize(
        lambda *a: grad(*a)), tracing_mode="fake")(*meta))
    return dot_flops(jg) - dot_flops(pg)


def named_gap(name: str, phase: str) -> dict:
    """The named differences of the reference's ``dot_general`` FLOPs over
    the port's, by cause."""
    cfg = ARCHS[name].reduced()
    tokens = 1 if phase == "decode" else T
    embed = 2 * B * tokens * cfg.padded_vocab() * cfg.d_model
    # the one-hot contraction, and in train its product for the table's
    # gradient (the one-hot operand has none)
    out = {"one-hot embedding": embed * (2 if phase == "train" else 1)}
    if cfg.family in ("ssm", "hybrid"):
        out["multi-operand einsums"] = cfg.n_layers * recurrence_gap(cfg,
                                                                     phase)
    if cfg.family == "encdec" and phase == "prefill":
        Te = get_model(cfg).enc_len(ShapeConfig("t", T, B, phase))
        out["second cross K/V"] = (cfg.n_layers * 2 *
                                   (2 * B * Te * cfg.d_model *
                                    cfg.n_kv_heads * cfg.hd))
    if phase == "train":
        if "multi-operand einsums" in out:
            # the recompute runs each block's recurrence forward once more
            out["multi-operand einsums"] += cfg.n_layers * recurrence_gap(
                cfg, "prefill")
        out["dead recomputed products"] = -dead_recompute(cfg)
    return out


def dead_recompute(cfg) -> float:
    """``dot_general`` FLOPs that the port's rematerialisation recomputes
    and the reference's does not: the backward reads the inputs of a
    rematerialised body's last product, never its output, so the
    reference's dead-code elimination drops that product from the
    recompute (a dense FFN's down projection, a Mamba2 block's output
    projection, an attention chunk's P.V), where the port's recompute runs
    the body whole.  An MoE block ends in the routing combine and an
    RWKV6 block in the gated channel mix, whose backward reads both
    products' outputs."""
    def pv(Tq, S):                                  # one attention's P.V
        return 2 * B * cfg.padded_heads * Tq * S * cfg.hd

    ffn = lambda n: 2 * B * n * cfg.d_ff * cfg.d_model   # noqa: E731
    if cfg.family in ("dense", "vlm", "moe"):
        return cfg.n_layers * (pv(T, T) + (0 if cfg.n_experts else ffn(T)))
    if cfg.family == "encdec":
        Te = get_model(cfg).enc_len(ShapeConfig("t", T, B, "train"))
        return (cfg.n_enc_layers * (pv(Te, Te) + ffn(Te)) +
                cfg.n_layers * (pv(T, T) + pv(T, Te) + ffn(T)))
    if cfg.family == "hybrid":
        from repro_torch.models.zamba2 import _split
        _, n_full, tail = _split(cfg)
        d_in = mamba2.dims(cfg)[0]
        return (cfg.n_layers * 2 * B * T * d_in * cfg.d_model +
                (n_full + (1 if tail else 0)) * pv(T, T))
    return 0.0


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_dot_flops_equal_reference_less_named_differences(name, phase):
    gap = named_gap(name, phase)
    assert dot_flops(ref_trace(name, phase)) - \
        dot_flops(port_trace(name, phase)) == sum(gap.values()), gap
    assert all(v > 0 for v in gap.values()), gap


@pytest.mark.parametrize("name", NAMES)
def test_train_dot_flops_equal_reference_less_named_differences(name):
    """The reference's own train trace, rematerialisation on, less the
    port's is the named gap; the reference's rematerialisation is real
    (its trace with ``jax.checkpoint`` made the identity has fewer
    products) and so is the port's: every forward product, its two
    backward products and the rematerialised forward again."""
    gap = named_gap(name, "train")
    port = dot_flops(port_trace(name, "train"))
    ref = dot_flops(ref_trace(name, "train"))
    assert ref - port == sum(gap.values()), gap
    assert ref > dot_flops(ref_trace(name, "train", remat=False))
    assert port > 3 * dot_flops(_forward_trace(name))


@functools.lru_cache(maxsize=None)
def _forward_trace(name):
    """The loss's forward alone, traced like the prefill."""
    from repro_torch.core.fxgraph import edag_from_fn
    api = get_model(ARCHS[name].reduced())
    batch = api.input_specs(ShapeConfig("t", T, B, "train"))
    return edag_from_fn(api.loss_fn, api.abstract(), batch)


@pytest.mark.parametrize("name", NAMES)
def test_train_phase_traces_grad_graph(name):
    g, gp = port_trace(name, "train"), port_trace(name, "prefill")
    # the backward pass roughly doubles the graph; definitely bigger
    assert g.n_vertices > 2 * gp.n_vertices
    r = report(g)
    assert r.D < r.W


@pytest.mark.parametrize("name,phase", [("qwen3-0.6b", "prefill"),
                                        ("rwkv6-7b", "decode"),
                                        ("seamless-m4t-large-v2", "train")])
def test_meta_and_cpu_inputs_give_one_edag(name, phase):
    """Tracing never runs the model: CPU tensors in place of the ``meta``
    inputs give the same eDAG."""
    api = get_model(ARCHS[name].reduced())
    fn, args = tracing._phase_fn(api, phase, T, B)
    cpu = tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype)
                   if isinstance(a, torch.Tensor) else a, args)
    from repro_torch.core.fxgraph import edag_from_graph
    g = edag_from_graph(tracing._capture(phase, fn, cpu),
                        mem_threshold_bytes=tracing.DEFAULT_MEM_THRESHOLD)
    assert g.trace_digest() == port_trace(name, phase).trace_digest()


def test_unknown_phase_and_config_raise():
    with pytest.raises(ValueError, match="phase"):
        tracing.trace_model("qwen3-0.6b", "serve", use_store=False)
    with pytest.raises(KeyError, match="qwen3-0.6b"):
        tracing.trace_model("not-a-model", use_store=False)


# ------------------------------------------------------------------- grids

@settings(deadline=None, max_examples=8)
@given(st.lists(st.sampled_from([1.0, 2.0, 8.0, 50.0, 200.0, 1000.0]),
                min_size=1, max_size=3),
       st.lists(st.sampled_from([1.0, 4.0, 64.0, 400.0]),
                min_size=1, max_size=3))
def test_suite_vs_solo_bit_identity_property(alphas_a, alphas_b):
    """Two model eDAGs with different request alphas, run as one union
    suite over the merged alpha axis: every per-trace field equals the
    solo ``grid_report`` bit for bit at the shared points."""
    alphas_a, alphas_b = set(alphas_a), set(alphas_b)
    ga = port_trace("qwen3-0.6b", "decode")
    gb = port_trace("rwkv6-7b", "decode")
    union = np.array(sorted(alphas_a | alphas_b))
    suite = EDagSuite([ga, gb], names=["a", "b"])
    sr = suite_grid_report(suite, union, ms=(2, 8), compute_slots=(0, 4),
                           simulate_points=True)
    for k, (g, mine) in enumerate([(ga, alphas_a), (gb, alphas_b)]):
        solo = grid_report(g, np.array(sorted(mine)), ms=(2, 8),
                           compute_slots=(0, 4), simulate_points=True)
        idx = np.searchsorted(union, np.array(sorted(mine)))
        assert float(solo["W"]) == float(np.asarray(sr["W"])[k])
        assert float(solo["D"]) == float(np.asarray(sr["D"])[k])
        assert float(solo["C"]) == float(np.asarray(sr["C"])[k])
        assert np.array_equal(solo["lam"], np.asarray(sr["lam"])[k])
        for key in ("t_inf", "t_lower", "t_upper", "Lam", "simulated"):
            assert np.array_equal(np.asarray(solo[key]),
                                  np.asarray(sr[key])[k][idx]), key


def _bits_equal(a, b, key):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and a.tobytes() == b.tobytes(), key


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_port_edags_analysed_alike_in_both_packages(phase):
    """The six port traces of a phase as one union suite, through both
    packages' ``suite_grid_report`` with simulated points: every field bit
    for bit."""
    graphs = [port_trace(n, phase) for n in NAMES]
    ref = []
    for g in graphs:
        g._finalize()
        ref.append(R.EDag.from_arrays(g.cost, g.is_mem, g.nbytes, g.src,
                                      g.dst))
    kw = dict(ms=(2, 8), compute_slots=(0, 4), simulate_points=True)
    alphas = [2.0, 60.0, 300.0]
    got = suite_grid_report(EDagSuite(graphs, names=NAMES), alphas, **kw)
    want = R.suite_grid_report(R.EDagSuite(ref, names=NAMES), alphas, **kw)
    assert sorted(got) == sorted(want)
    assert got.pop("names") == want.pop("names") == NAMES
    for key in want:
        _bits_equal(got[key], want[key], key)


def test_model_grid_report_equals_fixture(monkeypatch):
    """``model_grid_report`` over the six prefill traces (this module's
    traces, which ``test_family_shape_and_digest_pinned`` holds to the
    fixture's) equals the JAX package's ``suite_grid_report`` of the same
    eDAGs (the fixture)."""
    want = expected()["grid"]
    cfg = expected()["config"]["grid"]
    names = want["names"]
    monkeypatch.setattr(tracing, "trace_model",
                        lambda name, phase, **kw: port_trace(name, phase))
    rep = tracing.model_grid_report(names, cfg["alphas"], "prefill",
                                    ms=tuple(cfg["ms"]),
                                    compute_slots=tuple(cfg["compute_slots"]))
    assert rep["names"] == names
    assert sorted(rep) == sorted(want)
    for key in want:
        if key != "names":
            _bits_equal(rep[key], want[key], key)


# ---------------------------------------------------- store, objects, parts

def test_trace_store_dedup_roundtrip(tmp_path, monkeypatch):
    """A second identical request is served from the digest-addressed
    store through the request-key index: the same digest and analysis
    arrays, no re-trace; the key names the torch version, never jax."""
    monkeypatch.setenv("EDAN_TRACE_STORE", str(tmp_path))
    g1 = tracing.trace_model("qwen3-0.6b", "decode")
    idx = tmp_path / "model_traces.json"
    assert idx.exists()
    keys = list(__import__("json").loads(idx.read_text()))
    assert len(keys) == 1 and f"torch={torch.__version__}" in keys[0]
    assert "jax=" not in keys[0]
    calls = []
    monkeypatch.setattr(tracing, "_capture",
                        lambda *a: calls.append(a) or None)
    g2 = tracing.trace_model("qwen3-0.6b", "decode")
    assert not calls
    assert g2.trace_digest() == g1.trace_digest()
    assert np.array_equal(g2.cost, g1.cost)
    assert np.array_equal(g2.is_mem, g1.is_mem)
    # a different phase is a different key and a different digest
    monkeypatch.undo()
    monkeypatch.setenv("EDAN_TRACE_STORE", str(tmp_path))
    g3 = tracing.trace_model("qwen3-0.6b", "prefill")
    assert g3.trace_digest() != g1.trace_digest()


def test_model_objects_feed_placement_search():
    """Placement over a model decode step: label objects ride
    ``search_placement`` and the documented bound holds."""
    g = port_trace("qwen3-0.6b", "decode")
    objs = tracing.model_objects(g)
    assert len(objs) >= 2
    assert all(o.traffic > 0 and len(o.vertices) for o in objs)
    total = sum(o.nbytes for o in objs)
    rep = search_placement(g, alpha_local=2.0, alpha_remote=400.0,
                           budget=total // 2, objects=objs, m=4)
    assert rep.all_local <= rep.makespan <= rep.all_remote
    assert set(rep.local) <= {o.name for o in objs}
    # the reference's grouping of the same eDAG
    rg = R.EDag.from_arrays(g.cost, g.is_mem, g.nbytes, g.src, g.dst,
                            labels=list(g.labels()))
    want = RT.model_objects(rg)
    assert [(o.name, o.nbytes, list(o.vertices)) for o in objs] == \
        [(o.name, o.nbytes, list(o.vertices)) for o in want]
    folded = tracing.model_objects(g, min_vertices=10 ** 6)
    assert [o.name for o in folded] == ["<other>"]


def test_model_objects_require_labels():
    g = port_trace("qwen3-0.6b", "decode")
    stripped = type(g).from_arrays(g.cost, g.is_mem, g.nbytes, g.src, g.dst)
    with pytest.raises(ValueError, match="labels"):
        tracing.model_objects(stripped)


@pytest.mark.parametrize("kind", tracing.COMPONENTS)
def test_component_traces_are_parallel_not_chains(kind):
    g = tracing.trace_component(kind)
    r = report(g)
    assert g.n_vertices > 1
    assert r.D <= r.W
    if kind in ("attention", "ssm"):
        # chunked scans leave real width: many accesses per mem layer
        assert r.W > 2 * r.D


def test_component_unknown_kind_raises():
    with pytest.raises(ValueError, match="mlp"):
        tracing.trace_component("conv")


@pytest.mark.parametrize("phase", tracing.PHASES)
def test_model_summary_terms(phase):
    """The counterpart of ``model_hlo_summary``: its keys, the FLOPs
    PyTorch's counter sees (the contractions: equal to the trace's
    ``dot_general`` FLOPs) and the trace's memory bytes."""
    h = tracing.model_summary("qwen3-0.6b", phase)
    assert sorted(h) == ["flops", "hbm_bytes", "n_computations"]
    g = port_trace("qwen3-0.6b", phase)
    assert h["flops"] == dot_flops(g) > 0
    assert h["hbm_bytes"] == float(g.nbytes[g.is_mem].sum()) > 0
    assert h["n_computations"] >= 1


def test_reduced_false_uses_the_full_config(monkeypatch):
    """``reduced=False`` traces the full config (not run here at full
    depth): the api it builds has the full widths."""
    seen = []
    monkeypatch.setattr(tracing, "_capture", lambda phase, fn, args:
                        seen.append(args[0]["embed"].shape) or
                        _tiny_graph())
    tracing.trace_model("qwen3-0.6b", "decode", reduced=False,
                        use_store=False)
    cfg = ARCHS["qwen3-0.6b"]
    assert seen == [torch.Size([cfg.padded_vocab(), cfg.d_model])]


def test_full_width_trace_at_a_cut_depth_is_recorded(tmp_path,
                                                     monkeypatch):
    """A ``ModelConfig`` is traced as given: qwen3-0.6b's decode at full
    width and ``zoo_expected.py``'s ``FULL_LAYERS`` layers (the trace the
    chip smoke test times) is the recorded eDAG, and the trace store keeps
    it under its own key, not the named config's."""
    monkeypatch.setenv("EDAN_TRACE_STORE", str(tmp_path))
    want = expected()
    arch, phase = want["config"]["full"]
    cfg = dataclasses.replace(get_config(arch),
                              n_layers=want["config"]["full_layers"])
    g = tracing.trace_model(cfg, phase)
    got = want["full_trace"]
    assert (g.n_vertices, g.n_edges, int(g.is_mem.sum())) == \
        (got["vertices"], got["edges"], got["mem_vertices"])
    assert g.trace_digest() == got["digest"]
    index = json.loads((tmp_path / tracing._INDEX_NAME).read_text())
    assert list(index.values()) == [got["digest"]]
    assert not any(k.startswith(arch + "|") for k in index)


def _tiny_graph():
    from repro_torch.core.fxgraph import capture
    return capture(lambda x: x + 1, torch.empty(4, device="meta"))
