"""The port's serving path on the CPU: ``ServeEngine`` against the
reference package's engine (rwkv6; qwen3, granite-moe with and without
token drops, internvl2; seamless-m4t in ``test_torch_encdec.py``) and
against the reference's per-request prefill + greedy decode loop (zamba2
with 2 slots, which the reference's engine cannot serve: its batch axis is
fixed at 1), the serving launcher, and the card fixture's expected values
(all six families).

Greedy tokens must be equal.  The fixture's logits are held to 1e-4 of
their largest magnitude (the port's CPU path measured <= 2e-5 against
the reference's).
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import get_model as ref_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import ARCHS
from repro_torch.launch import serve as launch
from repro_torch.models import get_model
from repro_torch.models.module import (init_params_numpy,
                                       params_from_numpy)
from repro_torch.serve import Request, ServeEngine, prefill_batch


@pytest.fixture(autouse=True)
def _on_the_host(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")


EXPECTED = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "configs" / "serve_expected.json"


def _pair(name, seed, **overrides):
    rcfg = dataclasses.replace(REF_ARCHS[name].reduced(), **overrides)
    cfg = dataclasses.replace(ARCHS[name].reduced(), **overrides)
    rapi = ref_model(rcfg)
    rp = rapi.init(jax.random.PRNGKey(seed))
    return rapi, rp, get_model(cfg), params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rp))


def _prompts(n, length, seed):
    return np.random.default_rng(seed).integers(1, 200, (n, length)).tolist()


def test_rwkv6_engine_tokens_equal_reference_engine():
    rapi, rp, api, p = _pair("rwkv6-7b", 1)
    prompts = _prompts(3, 6, 0)
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
    assert eng.stats["prefills"] == 3 and eng.stats["decode_steps"] == 8


DROPS = dict(n_experts=32, top_k=8, capacity_factor=1.25)


@pytest.mark.parametrize("name,overrides", [
    ("qwen3-0.6b", {}), ("granite-moe-1b-a400m", {}),
    ("granite-moe-1b-a400m", DROPS), ("internvl2-2b", {})],
    ids=["qwen3", "granite", "granite-drops", "internvl2"])
def test_transformer_engine_tokens_equal_reference_engine(name, overrides):
    """Three prompts over two slots: the third is served beside an idle
    slot (token 0, a stale cache), which with capacity-dropping MoE
    (granite-drops: capacity 1 per expert in a decode step) changes the
    live slot's output in both engines alike.  A vlm's prompts start with
    its n_patches placeholders."""
    rapi, rp, api, p = _pair(name, 4, **overrides)
    P = api.cfg.n_patches if api.cfg.family == "vlm" else 0
    prompts = [[0] * P + q for q in _prompts(3, 6, 2)]
    ref_eng = RefEngine(rapi, rp, batch_slots=2, max_seq=P + 16)
    eng = ServeEngine(api, p, batch_slots=2, max_seq=P + 16)
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
    assert eng.stats["prefills"] == 3 and eng.stats["decode_steps"] == 8


def test_vlm_prompt_shorter_than_its_prefix_raises():
    _, _, api, p = _pair("internvl2-2b", 1)
    eng = ServeEngine(api, p, batch_slots=2, max_seq=32)
    eng.submit(Request(prompt=[1, 2, 3, 4], max_tokens=3))
    with pytest.raises(ValueError, match="shorter than its prefix"):
        eng.run_until_done()


def test_launcher_serves_a_vlm_after_its_placeholders():
    cfg = ARCHS["internvl2-2b"].reduced()
    res = launch.run(cfg, requests=3, slots=2, max_tokens=4, prompt_len=8,
                     device="cpu", emit=lambda s: None)
    assert res["requests"] == 3 and res["tokens"] == 12
    for r in res["done"]:
        assert len(r.prompt) == cfg.n_patches + 8
        assert r.prompt[:cfg.n_patches] == [0] * cfg.n_patches
    with pytest.raises(ValueError, match="do not fit"):
        launch.run(cfg, requests=1, max_seq=16, prompt_len=8, device="cpu")


def _ref_greedy(rapi, rp, prompt, n_new, max_seq):
    prefill = jax.jit(rapi.prefill_fn, static_argnames="cache_len")
    decode = jax.jit(rapi.decode_fn)
    logits, state = prefill(
        rp, {"tokens": jnp.asarray([prompt], jnp.int32)}, cache_len=max_seq)
    out = [int(jnp.argmax(logits[0]))]
    for step in range(n_new - 1):
        logits, state = decode(
            rp, state, {"tokens": jnp.asarray([[out[-1]]], jnp.int32),
                        "cur_index": jnp.int32(len(prompt) + step)})
        out.append(int(jnp.argmax(logits[0])))
    return out


def test_zamba2_engine_two_slots_equals_reference_loop():
    """The batch axis of every cache leaf comes from the family's
    cache_specs: zamba2's grouped Mamba state has it at axis 2."""
    rapi, rp, api, p = _pair("zamba2-7b", 2)
    prompts = _prompts(3, 5, 1)
    eng = ServeEngine(api, p, batch_slots=2, max_seq=24)
    assert eng.bdims["mamba"]["groups"]["S"] == 2
    assert eng.bdims["kv"]["k"] == 1
    reqs = [Request(prompt=q, max_tokens=4, rid=i)
            for i, q in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    assert len(eng.run_until_done()) == 3
    for r in reqs:
        assert r.output == _ref_greedy(rapi, rp, r.prompt, 4, 24), r.rid


def test_engine_rejects_mixed_prompt_lengths():
    _, _, api, p = _pair("rwkv6-7b", 1)
    eng = ServeEngine(api, p, batch_slots=2, max_seq=32)
    eng.submit(Request(prompt=[1, 2, 3], max_tokens=3))
    eng.submit(Request(prompt=[1, 2], max_tokens=3))
    with pytest.raises(ValueError, match="length bucket"):
        eng.run_until_done()


def test_request_done_in_its_first_tick_is_returned():
    """ROADMAP §C 22: a request admitted and finished by the same tick (a
    prefill token and one decode token, ``max_tokens=2``) is returned by
    the port's ``run_until_done``; the reference's drops it (it looks only
    at the slots held before the tick)."""
    rapi, rp, api, p = _pair("qwen3-0.6b", 1)
    prompt = _prompts(1, 6, 3)[0]
    ref_eng = RefEngine(rapi, rp, batch_slots=1, max_seq=32)
    ref_eng.submit(RefRequest(prompt=prompt, max_tokens=2))
    assert ref_eng.run_until_done() == []
    eng = ServeEngine(api, p, batch_slots=1, max_seq=32)
    eng.submit(Request(prompt=prompt, max_tokens=2))
    (done,) = eng.run_until_done()
    assert done.done and len(done.output) == 2


def test_temperature_sampling_is_seeded():
    _, _, api, p = _pair("rwkv6-7b", 1)
    outs = []
    for _ in range(2):
        eng = ServeEngine(api, p, batch_slots=2, max_seq=32, seed=5)
        reqs = [Request(prompt=[4, 5, 6], max_tokens=6, temperature=0.9,
                        rid=i) for i in range(2)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert all(0 <= t < api.cfg.padded_vocab() for o in outs[0] for t in o)


def test_launcher_cli_on_the_host(capsys):
    launch.main(["--arch", "zamba2-7b", "--requests", "3", "--slots", "2",
                 "--max-tokens", "3", "--max-seq", "16"])
    assert "3 requests, 9 tokens" in capsys.readouterr().out
    args = launch.parser().parse_args(["--arch", "rwkv6-7b", "--no-reduced"])
    assert args.reduced is False
    assert launch.parser().parse_args([]).reduced is True


def test_launcher_serves_seamless_on_the_host(capsys):
    """``--arch seamless-m4t-large-v2`` serves the reduced encoder-decoder
    over zero frames as long as each prompt."""
    launch.main(["--arch", "seamless-m4t-large-v2", "--requests", "3",
                 "--slots", "2", "--max-tokens", "3", "--max-seq", "16"])
    assert "3 requests, 9 tokens" in capsys.readouterr().out


def test_launcher_default_arch_is_the_references():
    """``python -m repro_torch.launch.serve`` with no ``--arch`` serves what
    ``python -m repro.launch.serve`` serves."""
    import inspect

    from repro.launch import serve as ref_launch
    src = inspect.getsource(ref_launch.main)
    ref_default = src.split('"--arch", default="', 1)[1].split('"', 1)[0]
    assert ref_default == "qwen3-0.6b"
    args = launch.parser().parse_args([])
    assert args.arch == ref_default


def test_launcher_run_reports_the_engine():
    res = launch.run(ARCHS["rwkv6-7b"].reduced(), requests=4, slots=2,
                     max_seq=32, max_tokens=4, prompt_len=8, device="cpu",
                     emit=lambda s: None)
    assert res["requests"] == 4 and res["tokens"] == 16
    assert res["stats"]["prefills"] == 4 and res["stats"]["decode_steps"] == 6
    assert res["device"] == "cpu"


@pytest.mark.parametrize("index", [0, 1, 2, 3, 4, 5])
def test_card_fixture_on_the_host(index):
    """The port's CPU path reproduces serve_expected.json: the reference's
    greedy tokens exactly, its prefill logits within 1e-4."""
    fx = json.loads(EXPECTED.read_text())["fixtures"][index]
    cfg = dataclasses.replace(ARCHS[fx["arch"]], **fx["overrides"])
    api = get_model(cfg)
    p = params_from_numpy(init_params_numpy(api.specs(), fx["seed"]))
    eng = ServeEngine(api, p, batch_slots=2,
                      max_seq=fx["prompt_len"] + fx["n_new"])
    reqs = [Request(prompt=r["prompt"], max_tokens=fx["n_new"], rid=i)
            for i, r in enumerate(fx["runs"])]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    for r, want in zip(reqs, fx["runs"]):
        assert r.output == want["tokens"]
        with torch.inference_mode():
            logits, _ = api.prefill_fn(p, prefill_batch(cfg, torch.tensor(
                [r.prompt])), cache_len=fx["prompt_len"])
        w = np.asarray(want["logits"])
        assert np.abs(logits[0].numpy() - w).max() < 1e-4 * np.abs(w).max()
