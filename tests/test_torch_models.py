"""The port's model zoo (every family; ``encdec`` has its own file,
``test_torch_encdec.py``) against the reference package on the CPU:
parameter specs, parameter counts, and forward / prefill / decode of
rwkv6, zamba2 and the transformer families (qwen3, granite-moe with and
without token drops, internvl2 with a patch prefix, mixtral's
sliding-window cache, deepseek-coder's padded heads) at reduced width with
the reference's ``init`` weights carried across by ``params_from_numpy``;
the MoE dispatch's slots, gates and drops; ``cross_entropy`` and every
family's ``loss_fn`` with its gradient (``module.value_and_grad`` against
``jax.grad``).

Both packages run the same float32 algorithm at reduced width (the
chunked recurrences and ``attention_ref`` on the CPU), summed in other
orders, so logits, decode state and losses are held to 1e-4 of their
largest magnitude (measured <= 2e-5).  Gradients are held leaf by leaf to
``GRAD_TOL`` of each leaf's largest magnitude: measured <= 2.6e-5, except
seamless's encoder weights at 2.8e-4, whose gradient flows back through
the cross-attention that amplifies the encoder's rounding
(``test_torch_encdec.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import get_model as ref_model
from repro.configs.base import ShapeConfig as RefShape
from repro.models.module import is_spec
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import PORTED, get_model
from repro_torch.models.module import (init_params, init_params_numpy,
                                       param_bytes, params_from_numpy,
                                       tree_leaves, value_and_grad)


@pytest.fixture(autouse=True)
def _on_the_host(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")


TOL = 1e-4
GRAD_TOL = 1e-3
PORTED_ARCHS = sorted(n for n, c in ARCHS.items() if c.family in PORTED)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _spec_table(specs, ref: bool) -> dict:
    """{path: (shape, logical, init, scale, dtype name)} of a spec tree."""
    if ref:
        flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=is_spec)[0]
        return {jax.tree_util.keystr(p): (s.shape, s.logical, s.init, s.scale,
                                          jnp.dtype(s.dtype).name)
                for p, s in flat}
    out = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + f"[{k!r}]")
            else:
                out[path + f"[{k!r}]"] = (v.shape, v.logical, v.init,
                                          v.scale, str(v.dtype).split(".")[1])
    walk(specs, "")
    return out


def test_registry_names_every_architecture():
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(ARCHS[name]) == \
            dataclasses.asdict(REF_ARCHS[name])
        assert dataclasses.asdict(ARCHS[name].reduced()) == \
            dataclasses.asdict(REF_ARCHS[name].reduced())
    with pytest.raises(KeyError):
        get_config("no-such-model")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", PORTED_ARCHS)
def test_specs_equal_reference(name, reduced):
    cfg, rcfg = ARCHS[name], REF_ARCHS[name]
    if reduced:
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    assert _spec_table(get_model(cfg).specs(), False) == \
        _spec_table(ref_model(rcfg).specs(), True)
    shape = ShapeConfig("decode", 64, 3, "decode")
    rshape = RefShape("decode", 64, 3, "decode")
    assert _spec_table(get_model(cfg).cache_specs(shape), False) == \
        _spec_table(ref_model(rcfg).cache_specs(rshape), True)


def test_full_width_parameter_counts():
    assert get_model(ARCHS["rwkv6-7b"]).n_params() == 7_534_546_944
    assert get_model(ARCHS["zamba2-7b"]).n_params() == 6_634_892_880
    assert param_bytes(get_model(ARCHS["rwkv6-7b"]).specs()) == \
        4 * 7_534_546_944
    assert get_model(ARCHS["qwen3-0.6b"]).n_params() == 751_632_384
    assert get_model(ARCHS["granite-moe-1b-a400m"]).n_params() == \
        1_384_989_696
    assert get_model(ARCHS["internvl2-2b"]).n_params() == 1_889_175_552


def test_unported_families_raise():
    """No family is left unported: every config of ``ARCHS`` builds, at
    full width and reduced, with the reference's parameter count."""
    assert sorted({c.family for c in ARCHS.values()}) == sorted(PORTED)
    for name, cfg in ARCHS.items():
        for c, rc in ((cfg, REF_ARCHS[name]),
                      (cfg.reduced(), REF_ARCHS[name].reduced())):
            assert get_model(c).n_params() == ref_model(rc).n_params()


def test_init_distributions():
    cfg = ARCHS["zamba2-7b"].reduced()
    api = get_model(cfg)
    p = api.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    q = params_from_numpy(init_params_numpy(api.specs(), 0))
    again = init_params(api.specs(), torch.Generator().manual_seed(0))
    for s, a, b, c in zip(tree_leaves(api.specs()), tree_leaves(p),
                          tree_leaves(q), tree_leaves(again)):
        assert a.shape == b.shape == s.shape and a.dtype == b.dtype
        assert torch.equal(a, c)
        if s.init == "zeros":
            assert not a.any() and not b.any()
        elif s.init == "ones":
            assert (a == 1).all() and (b == 1).all()
        elif a.numel() >= 4096:
            for t in (a, b):
                assert abs(t.std().item() / s.std - 1) < 0.1


CASES = [("rwkv6-7b", None), ("zamba2-7b", None), ("zamba2-7b", 3)]


def _pair(name, n_layers):
    cfg, rcfg = ARCHS[name].reduced(), REF_ARCHS[name].reduced()
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        rcfg = dataclasses.replace(rcfg, n_layers=n_layers)
    rapi, api = ref_model(rcfg), get_model(cfg)
    rp = rapi.init(jax.random.PRNGKey(3))
    return rapi, api, rp, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rp))


def _leaves_with_paths(ref_tree, port_tree):
    """(path, reference leaf, port leaf) for every leaf of the reference's
    tree (None leaves skipped)."""
    flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    out = []
    for path, leaf in flat:
        t = port_tree
        for p in path:
            t = t[p.key if hasattr(p, "key") else p.idx]
        out.append((jax.tree_util.keystr(path), leaf, t))
    return out


@pytest.mark.parametrize("name,n_layers", CASES)
def test_prefill_and_decode_match_reference(name, n_layers):
    rapi, api, rp, p = _pair(name, n_layers)
    toks = np.random.default_rng(0).integers(0, 256, (2, 12)).astype(np.int32)
    rl, rst = jax.jit(rapi.prefill_fn, static_argnames="cache_len")(
        rp, {"tokens": jnp.asarray(toks)}, cache_len=16)
    with torch.inference_mode():
        pl, pst = api.prefill_fn(p, {"tokens": torch.from_numpy(toks).long()},
                                 cache_len=16)
    assert rel_err(pl, rl) < TOL
    for key, a, b in _leaves_with_paths(rst, pst):
        assert rel_err(b.float(), a) < TOL, key
    nxt = np.argmax(np.asarray(rl), -1).astype(np.int32)[:, None]
    rl2, rst2 = jax.jit(rapi.decode_fn)(rp, rst, {
        "tokens": jnp.asarray(nxt), "cur_index": jnp.int32(12)})
    with torch.inference_mode():
        pl2, pst2 = api.decode_fn(p, pst, {"tokens": torch.from_numpy(nxt)
                                           .long(), "cur_index": 12})
    assert rel_err(pl2, rl2) < TOL
    for key, a, b in _leaves_with_paths(rst2, pst2):
        assert rel_err(b.float(), a) < TOL, key


@pytest.mark.parametrize("name,n_layers", CASES)
def test_forward_matches_reference_and_prefill_decode(name, n_layers):
    """forward equals the reference's; prefill of T tokens then one decode
    step gives forward's logits at positions T-1 and T."""
    rapi, api, rp, p = _pair(name, n_layers)
    fam = {"ssm": "rwkv6", "hybrid": "zamba2"}[api.cfg.family]
    rmod = __import__(f"repro.models.{fam}", fromlist=["forward"])
    pmod = __import__(f"repro_torch.models.{fam}", fromlist=["forward"])
    toks = np.random.default_rng(1).integers(0, 256, (2, 10)).astype(np.int32)
    t = torch.from_numpy(toks).long()
    with torch.inference_mode():
        full = pmod.forward(p, t, api.cfg)
        last, st = api.prefill_fn(p, {"tokens": t[:, :9]}, cache_len=10)
        step, _ = api.decode_fn(p, st, {"tokens": t[:, 9:], "cur_index": 9})
    assert rel_err(full, rmod.forward(rp, jnp.asarray(toks), rapi.cfg)) < TOL
    assert rel_err(last, full[:, 8]) < TOL
    assert rel_err(step, full[:, 9]) < TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    """rms_norm, rope, the chunked attention (causal, windowed, offset) and
    the decode attention against the reference's, same inputs; bf16 in
    bf16, held to one bf16 rounding of the largest magnitude."""
    from repro.models import layers as rl
    from repro_torch.models import layers as pl
    tol = TOL if dtype == "float32" else 2.0 ** -7
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    w = rng.standard_normal(8).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    J = [jnp.asarray(a).astype(jd) for a in (x, k, v)]
    T = [torch.from_numpy(a).to(td) for a in (x, k, v)]

    def same(got, want):
        assert rel_err(got.float(), np.asarray(want, np.float32)) < tol

    same(pl.rms_norm(T[0], torch.from_numpy(w)), rl.rms_norm(J[0], w))
    pos = np.arange(16) + 3
    same(pl.rope(T[0], torch.from_numpy(pos)), rl.rope(J[0], jnp.asarray(pos)))
    for kw in (dict(causal=True), dict(causal=False),
               dict(causal=True, window=5), dict(causal=True, q_offset=4)):
        same(pl.attention_ref(*T, chunk_kv=4, **kw),
             rl.attention_ref(*J, chunk_kv=4, **kw))
    same(pl.attention_decode(T[0][:, :1], T[1], T[2], 9),
         rl.attention_decode(J[0][:, :1], J[1], J[2], 9))


# ------------------------------------------------------ transformer families

DROPS = dict(n_experts=32, top_k=8, capacity_factor=1.25)
TRANSFORMER_CASES = [
    ("qwen3-0.6b", {}), ("granite-moe-1b-a400m", {}),
    ("granite-moe-1b-a400m", DROPS), ("internvl2-2b", {}),
    ("mixtral-8x7b", {}), ("deepseek-coder-33b", dict(head_pad_to=8)),
]
TRANSFORMER_IDS = ["qwen3", "granite", "granite-drops", "internvl2",
                   "mixtral-window", "deepseek-coder-padded"]


def _tpair(name, overrides):
    cfg = dataclasses.replace(ARCHS[name].reduced(), **overrides)
    rcfg = dataclasses.replace(REF_ARCHS[name].reduced(), **overrides)
    rapi, api = ref_model(rcfg), get_model(cfg)
    rp = rapi.init(jax.random.PRNGKey(3))
    return rapi, api, rp, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rp))


def _batches(cfg, toks, seed=1):
    """The same prefill batch for both packages; a vlm's carries random
    patch embeddings."""
    rb, pb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(
        toks).long()}
    if cfg.family == "vlm":
        pe = np.random.default_rng(seed).standard_normal(
            (toks.shape[0], cfg.n_patches, cfg.d_model)).astype(np.float32)
        rb["prefix_embeds"], pb["prefix_embeds"] = (jnp.asarray(pe),
                                                    torch.from_numpy(pe))
    return rb, pb


@pytest.mark.parametrize("name,overrides", TRANSFORMER_CASES,
                         ids=TRANSFORMER_IDS)
def test_transformer_prefill_and_decode_match_reference(name, overrides):
    """20 prompt tokens (past mixtral's reduced window of 16, so its cache
    is rolled), a cache of 24, two decode steps."""
    rapi, api, rp, p = _tpair(name, overrides)
    toks = np.random.default_rng(0).integers(0, 256, (2, 20)).astype(np.int32)
    rb, pb = _batches(api.cfg, toks)
    rl, rst = jax.jit(rapi.prefill_fn, static_argnames="cache_len")(
        rp, rb, cache_len=24)
    with torch.inference_mode():
        pl, pst = api.prefill_fn(p, pb, cache_len=24)
    assert rel_err(pl, rl) < TOL
    for key in ("k", "v"):
        assert pst[key].shape == rst[key].shape
        assert rel_err(pst[key], rst[key]) < TOL, key
    decode = jax.jit(rapi.decode_fn)
    for cur in (20, 21):
        nxt = np.argmax(np.asarray(rl), -1).astype(np.int32)[:, None]
        rl, rst = decode(rp, rst, {"tokens": jnp.asarray(nxt),
                                   "cur_index": jnp.int32(cur)})
        with torch.inference_mode():
            pl, pst = api.decode_fn(p, pst, {"tokens": torch.from_numpy(nxt)
                                             .long(), "cur_index": cur})
        assert rel_err(pl, rl) < TOL
        for key in ("k", "v"):
            assert rel_err(pst[key], rst[key]) < TOL, key


@pytest.mark.parametrize("name,overrides", TRANSFORMER_CASES,
                         ids=TRANSFORMER_IDS)
def test_transformer_forward_matches_reference(name, overrides):
    """forward equals the reference's; without token drops, prefill of T
    tokens then one decode step gives forward's logits at positions T-1
    and T (with drops the capacity depends on the number of tokens in the
    call, so the two differ in both packages)."""
    from repro.models import transformer as rt
    from repro_torch.models import transformer as pt
    rapi, api, rp, p = _tpair(name, overrides)
    toks = np.random.default_rng(1).integers(0, 256, (2, 19)).astype(np.int32)
    rb, pb = _batches(api.cfg, toks)
    t = pb["tokens"]
    with torch.inference_mode():
        full, aux = pt.forward(p, t, api.cfg,
                               prefix_embeds=pb.get("prefix_embeds"))
        last, st = api.prefill_fn(p, dict(pb, tokens=t[:, :18]),
                                  cache_len=19)
        step, _ = api.decode_fn(p, st, {"tokens": t[:, 18:],
                                        "cur_index": 18})
    rfull, raux = rt.forward(rp, rb["tokens"], rapi.cfg,
                             prefix_embeds=rb.get("prefix_embeds"))
    assert rel_err(full, rfull) < TOL
    assert abs(float(aux) - float(raux)) <= TOL * max(abs(float(raux)), 1)
    if overrides != DROPS:
        assert rel_err(last, full[:, 17]) < TOL
        assert rel_err(step, full[:, 18]) < TOL


def test_vlm_prompt_shorter_than_its_prefix_raises():
    _, api, _, p = _tpair("internvl2-2b", {})
    P = api.cfg.n_patches
    with pytest.raises(ValueError, match="shorter than its prefix"):
        api.prefill_fn(p, {"tokens": torch.ones((1, P - 1), dtype=torch.long),
                           "prefix_embeds": torch.zeros((1, P, 64))},
                       cache_len=32)


@pytest.mark.parametrize("n", [2, 6, 128])
def test_moe_dispatch_equals_reference(n):
    """Slots, tokens, gates, buffers, aux and the combine of the capacity
    dispatch at 32 experts, top-8, capacity factor 1.25 (the full granite
    config's), with drops at every n here."""
    from repro.models import moe as rmoe
    from repro_torch.models import moe as pmoe
    cfg = dataclasses.replace(ARCHS["granite-moe-1b-a400m"].reduced(),
                              **DROPS)
    rcfg = dataclasses.replace(REF_ARCHS["granite-moe-1b-a400m"].reduced(),
                               **DROPS)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 32)) / 8).astype(np.float32)
    C = pmoe._capacity(n, cfg)
    assert C == rmoe._capacity(n, rcfg)
    got = pmoe._dispatch(torch.from_numpy(x), torch.from_numpy(w), cfg, C)
    want = rmoe._dispatch(jnp.asarray(x), jnp.asarray(w), rcfg, C)
    buf, slot, tok, gate, aux = got
    assert np.array_equal(slot.numpy(), np.asarray(want[1]))
    assert np.array_equal(tok.numpy(), np.asarray(want[2]))
    assert (slot.numpy() == 32 * C).sum() > 0          # tokens dropped
    assert rel_err(gate, want[3]) < TOL and rel_err(buf, want[0]) < TOL
    assert abs(float(aux) - float(want[4])) < TOL
    y = rng.standard_normal((32, C, 64)).astype(np.float32)
    assert rel_err(pmoe._combine(torch.from_numpy(y), slot, tok, gate, n),
                   rmoe._combine(jnp.asarray(y), want[1], want[2], want[3],
                                 n)) < TOL


# ------------------------------------------------------------------ training

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(z_loss, masked):
    from repro.models import layers as rl
    from repro_torch.models import layers as pl
    rng = np.random.default_rng(8)
    logits = (4 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32)
    m_r, m_p = ((jnp.asarray(mask), torch.from_numpy(mask)) if masked
                else (None, None))
    want = float(rl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                  z_loss=z_loss, mask=m_r))
    got = pl.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           z_loss=z_loss, mask=m_p)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= TOL * abs(want)
    # an all-zero mask divides by one, as the reference's maximum does
    zero = np.zeros((2, 7), np.float32)
    assert float(pl.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  mask=torch.from_numpy(zero))) == 0.0


LOSS_FAMILIES = ["qwen3-0.6b", "granite-moe-1b-a400m", "internvl2-2b",
                 "rwkv6-7b", "zamba2-7b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("name", LOSS_FAMILIES)
def test_loss_and_grad_match_reference(name):
    """Each family's ``loss_fn`` (with granite's MoE aux term) and its
    gradient with respect to every parameter, on the reference's weights:
    2 sequences of 12 tokens, random labels (a vlm's 8 patch embeddings and
    an encdec's 10 frames random too)."""
    rapi, api, rp, p = _tpair(name, {})
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, 12)).astype(np.int32)
    labels = rng.integers(0, 256, (2, 12)).astype(np.int32)
    rb, pb = _batches(api.cfg, toks)
    rb["labels"], pb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    if api.cfg.family == "encdec":
        fe = rng.standard_normal((2, 10, api.cfg.d_model)).astype(np.float32)
        rb["frame_embeds"], pb["frame_embeds"] = (jnp.asarray(fe),
                                                  torch.from_numpy(fe))
    want, rgrad = jax.value_and_grad(rapi.loss_fn)(rp, rb)
    got, grad = value_and_grad(api.loss_fn)(p, pb)
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    leaves = _leaves_with_paths(rgrad, grad)
    assert len(leaves) == len(tree_leaves(grad))
    for key, a, b in leaves:
        assert b.shape == a.shape, key
        assert rel_err(b, a) < GRAD_TOL, key


def test_ops_route_meta_tensors_to_the_plain_versions():
    """A ``meta`` tensor carries no data: the three dispatchers give the
    plain versions' shapes on meta (what tracing captures); mixed devices
    still raise."""
    from repro_torch.kernels import ops
    meta = lambda *s: torch.empty(s, device="meta")      # noqa: E731
    o = ops.flash_attention(meta(1, 8, 4, 16), meta(1, 8, 2, 16),
                            meta(1, 8, 2, 16), causal=False, block_kv=4)
    assert o.device.type == "meta" and tuple(o.shape) == (1, 8, 4, 16)
    y, S = ops.wkv6(*[meta(1, 2, 5, 8)] * 4, meta(2, 8), meta(1, 2, 8, 8))
    assert tuple(y.shape) == (1, 2, 5, 8) and S.device.type == "meta"
    y, S = ops.ssd(meta(1, 2, 5, 4), meta(1, 2, 5), meta(2),
                   meta(1, 1, 5, 3), meta(1, 1, 5, 3), meta(2),
                   meta(1, 2, 4, 3))
    assert tuple(y.shape) == (1, 2, 5, 4) and tuple(S.shape) == (1, 2, 4, 3)
    with pytest.raises(ValueError, match="meta"):
        ops.flash_attention(meta(1, 8, 4, 16), torch.zeros(1, 8, 2, 16),
                            torch.zeros(1, 8, 2, 16))
