"""The port's encoder-decoder family (seamless-m4t-large-v2,
``models/encdec.py``) against the reference package on the CPU: specs and
the full-width parameter count, forward, prefill and decode, the loss, the
engine's greedy tokens and the batch and cache layouts, at two layers of
the reduced width with the reference's ``init`` weights carried across by
``params_from_numpy``.

Both packages run the same float32 algorithm (``attention_ref`` with the
config's KV chunk of 16 on the CPU; the reference's encdec calls
``attention_ref`` directly, so no Pallas kernel is reached), summed in
other orders: logits, caches and losses are held to 1e-4 of their largest
magnitude, as in ``test_torch_models.py``.  The teacher-forced forward over
random frames is held in two halves at 1e-4 — the encoder, and the
decoder stack on the reference's encoder output — and end to end at
``FWD_TOL``: the encoders' outputs differ by ~4e-6 of their largest value
(summation order), and the random-init decoder's cross-attention
amplifies that ~30x (every sub-block of it, fed the same inputs, agrees
within 1e-6; measured 1.3e-4 end to end at Te = 12).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs.base import ShapeConfig as RefShape
from repro.models import encdec as rencdec
from repro.models import get_model as ref_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import encdec, get_model
from repro_torch.models.module import params_from_numpy
from repro_torch.serve import Request, ServeEngine, prefill_batch

NAME = "seamless-m4t-large-v2"
TOL = 1e-4
FWD_TOL = 1e-3


@pytest.fixture(autouse=True)
def _on_the_host(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def pair():
    rcfg, cfg = REF_ARCHS[NAME].reduced(), ARCHS[NAME].reduced()
    assert cfg.n_layers == cfg.n_enc_layers == 2
    rapi, api = ref_model(rcfg), get_model(cfg)
    rp = rapi.init(jax.random.PRNGKey(5))
    return rapi, api, rp, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rp))


def _inputs(B, Td, Te, d, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, Td)).astype(np.int32)
    frames = rng.standard_normal((B, Te, d)).astype(np.float32)
    return toks, frames


def test_full_width_parameter_count():
    assert get_model(ARCHS[NAME]).n_params() == 2_034_788_352
    assert get_model(ARCHS[NAME]).n_params() == \
        ref_model(REF_ARCHS[NAME]).n_params()


@pytest.mark.parametrize("Te", [12, 20, 5])
def test_forward_matches_reference(pair, Te):
    """Teacher-forced forward over Te frames and 12 tokens (Te = 12 is the
    engine's T = S; 20 and 5 hold the cross-attention with T != S)."""
    rapi, api, rp, p = pair
    toks, frames = _inputs(2, 12, Te, api.cfg.d_model, Te)
    want = rencdec.forward(rp, {"tokens": jnp.asarray(toks),
                                "frame_embeds": jnp.asarray(frames)},
                           rapi.cfg)
    renc = rencdec.encode(rp, jnp.asarray(frames), rapi.cfg)
    rdec, _ = rencdec.decode_stack(rp, jnp.asarray(toks), renc, rapi.cfg)
    with torch.inference_mode():
        got = encdec.forward(p, {"tokens": torch.from_numpy(toks),
                                 "frame_embeds": torch.from_numpy(frames)},
                             api.cfg)
        enc = encdec.encode(p, torch.from_numpy(frames), api.cfg)
        dec = encdec.decode_stack(p, torch.from_numpy(toks),
                                  torch.from_numpy(np.array(renc)), api.cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert enc.shape == (2, Te, api.cfg.d_model)
    assert rel_err(enc, renc) < TOL
    assert rel_err(dec, rdec) < TOL
    assert rel_err(got, want) < FWD_TOL


def test_prefill_and_decode_match_reference(pair):
    """A prompt of 10 tokens over 14 frames, a cache of 16, two decode
    steps: logits and every cache leaf."""
    rapi, api, rp, p = pair
    toks, frames = _inputs(2, 10, 14, api.cfg.d_model, 1)
    rl, rst = jax.jit(rapi.prefill_fn, static_argnames="cache_len")(
        rp, {"tokens": jnp.asarray(toks), "frame_embeds": jnp.asarray(frames)},
        cache_len=16)
    with torch.inference_mode():
        pl, pst = api.prefill_fn(p, {"tokens": torch.from_numpy(toks),
                                     "frame_embeds": torch.from_numpy(frames)},
                                 cache_len=16)
    assert rel_err(pl, rl) < TOL
    assert sorted(pst) == sorted(rst) == ["k", "v", "xk", "xv"]
    for key in rst:
        assert pst[key].shape == rst[key].shape, key
        assert rel_err(pst[key], rst[key]) < TOL, key
    decode = jax.jit(rapi.decode_fn)
    for cur in (10, 11):
        nxt = np.argmax(np.asarray(rl), -1).astype(np.int32)[:, None]
        rl, rst = decode(rp, rst, {"tokens": jnp.asarray(nxt),
                                   "cur_index": jnp.int32(cur)})
        with torch.inference_mode():
            pl, pst = api.decode_fn(p, pst, {"tokens": torch.from_numpy(nxt),
                                             "cur_index": cur})
        assert rel_err(pl, rl) < TOL
        for key in rst:
            assert rel_err(pst[key], rst[key]) < TOL, key


def test_prefill_then_decode_equals_forward(pair):
    """Prefill of T tokens then one decode step gives forward's logits at
    positions T-1 and T (the frames fixed)."""
    _, api, _, p = pair
    toks, frames = _inputs(2, 9, 9, api.cfg.d_model, 2)
    t, f = torch.from_numpy(toks), torch.from_numpy(frames)
    with torch.inference_mode():
        full = encdec.forward(p, {"tokens": t, "frame_embeds": f}, api.cfg)
        last, st = api.prefill_fn(p, {"tokens": t[:, :8], "frame_embeds": f},
                                  cache_len=9)
        step, _ = api.decode_fn(p, st, {"tokens": t[:, 8:], "cur_index": 8})
    assert rel_err(last, full[:, 7]) < TOL
    assert rel_err(step, full[:, 8]) < TOL


def test_prefill_cache_shorter_than_prompt_raises(pair):
    _, api, _, p = pair
    toks, frames = _inputs(1, 8, 8, api.cfg.d_model, 3)
    with pytest.raises(ValueError, match="cache_len"):
        api.prefill_fn(p, {"tokens": torch.from_numpy(toks),
                           "frame_embeds": torch.from_numpy(frames)},
                       cache_len=4)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_matches_reference(pair, masked):
    rapi, api, rp, p = pair
    toks, frames = _inputs(2, 12, 10, api.cfg.d_model, 4)
    labels = np.roll(toks, -1, axis=1)
    mask = (np.random.default_rng(6).random((2, 12)) < 0.7).astype(
        np.float32)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "frame_embeds": jnp.asarray(frames)}
    pb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels),
          "frame_embeds": torch.from_numpy(frames)}
    if masked:
        rb["mask"], pb["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    want = float(rapi.loss_fn(rp, rb))
    got = api.loss_fn(p, pb)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(float(got) - want) <= TOL * abs(want)


def test_engine_tokens_equal_reference_engine(pair):
    """Three 6-token prompts through 2 slots (the frames are zeros, as
    long as each prompt): greedy tokens equal the reference engine's."""
    rapi, api, rp, p = pair
    prompts = np.random.default_rng(7).integers(1, 200, (3, 6)).tolist()
    ref_eng = RefEngine(rapi, rp, batch_slots=2, max_seq=32)
    eng = ServeEngine(api, p, batch_slots=2, max_seq=32)
    ref_reqs = [RefRequest(prompt=q, max_tokens=5, rid=i)
                for i, q in enumerate(prompts)]
    reqs = [Request(prompt=q, max_tokens=5, rid=i)
            for i, q in enumerate(prompts)]
    for r in ref_reqs:
        ref_eng.submit(r)
    for r in reqs:
        eng.submit(r)
    assert len(ref_eng.run_until_done()) == len(eng.run_until_done()) == 3
    for a, b in zip(reqs, ref_reqs):
        assert a.output == b.output, a.rid
    assert eng.stats["prefills"] == 3


def test_prefill_batch_frames():
    cfg = dataclasses.replace(ARCHS[NAME].reduced(), enc_len_cap=6)
    b = prefill_batch(cfg, torch.ones((2, 9), dtype=torch.long))
    assert b["frame_embeds"].shape == (2, 6, cfg.d_model)
    assert b["frame_embeds"].dtype == torch.float32
    assert not b["frame_embeds"].any()
    b = prefill_batch(cfg, torch.ones((1, 4), dtype=torch.long))
    assert b["frame_embeds"].shape == (1, 4, cfg.d_model)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_and_cache_specs_equal_reference(kind):
    """``input_specs`` gives the reference's shapes and dtypes as meta
    tensors (decode's ``cur_index`` is the port's constant position), and
    the decode cache the reference's layout, at enc_len = min(seq,
    enc_len_cap)."""
    for cfg, rcfg in ((ARCHS[NAME], REF_ARCHS[NAME]),
                      (ARCHS[NAME].reduced(), REF_ARCHS[NAME].reduced())):
        shape, rshape = ShapeConfig("t", 40, 3, kind), RefShape("t", 40, 3,
                                                               kind)
        got = get_model(cfg).input_specs(shape)
        want, _ = ref_model(rcfg).input_specs(rshape)
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            if key == "cur_index":
                assert got[key] == 39
                continue
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(w.shape), key
            assert str(got[key].dtype).split(".")[1] == \
                jnp.dtype(w.dtype).name, key
        spec = get_model(cfg).cache_specs(shape)
        rspec = ref_model(rcfg).cache_specs(rshape)
        for key in ("k", "v", "xk", "xv"):
            assert spec[key].shape == rspec[key].shape
            assert spec[key].logical == rspec[key].logical
