"""The port's HLO frontend and ``collective_sensitivity`` against the JAX
package's, on the CPU.

Every case of ``tests/test_hlo.py`` through both packages, on the text
fixtures under ``src/repro_torch/configs/hlo/`` (``tools/
frontend_expected.py`` writes them: ``test_hlo.py``'s ``SYNTH``, its
compiled single-device scan module, and the (2, 4) ("data", "model") train
and decode steps ``test_dryrun_small.py``'s script compiles on 8 host
devices) and on a module jax compiles here; then the analysis half of
``test_dryrun_small.py`` on the port's results.  Results must be equal:
the same dicts, every float ``==``, and equal to
``configs/frontend_expected.json``.
"""
import gzip
import json
from pathlib import Path

import pytest

import repro.core as R
import repro_torch.core as T
from repro.core import hlo as rhlo
from repro.core import sensitivity as rsens
from repro_torch.core import hlo as thlo
from repro_torch.core import sensitivity as tsens

CONFIGS = Path(T.__file__).resolve().parents[1] / "configs"
EXPECTED = json.loads((CONFIGS / "frontend_expected.json").read_text())
FIXTURES = sorted(EXPECTED["hlo"])
SYNTH_AXES = [("data", 2), ("model", 4)]


@pytest.fixture(autouse=True)
def cpu_backend(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")


def text(name: str) -> str:
    return gzip.decompress((CONFIGS / "hlo" / f"{name}.hlo.gz")
                           .read_bytes()).decode()


def axes(name: str):
    return [tuple(a) for a in EXPECTED["hlo"][name]["mesh_axes"]]


def sens_rows(res) -> dict:
    return dict(per_axis={k: v.row() for k, v in res["per_axis"].items()},
                raw=res["raw"])


def jsonable(x):
    return json.loads(json.dumps(x))


def test_every_fixture_is_listed_and_small():
    assert FIXTURES == ["decode", "scan", "synth", "train"]
    total = sum((CONFIGS / "hlo" / f"{n}.hlo.gz").stat().st_size
                for n in FIXTURES)
    assert total < 1_000_000


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_text_is_the_recorded_one(name):
    assert len(text(name).encode()) == EXPECTED["hlo"][name]["text_bytes"]


@pytest.mark.parametrize("name", FIXTURES)
def test_analyze_collectives_equal(name):
    t = T.analyze_collectives(text(name), axes(name))
    assert t == R.analyze_collectives(text(name), axes(name))
    assert jsonable(t) == EXPECTED["hlo"][name]["analyze_collectives"]


@pytest.mark.parametrize("name", FIXTURES)
def test_flops_and_bytes_estimates_equal(name):
    txt = text(name)
    assert T.hlo_flops_estimate(txt) == R.hlo_flops_estimate(txt) == \
        EXPECTED["hlo"][name]["flops"]
    assert T.hlo_hbm_bytes_estimate(txt) == R.hlo_hbm_bytes_estimate(txt) \
        == EXPECTED["hlo"][name]["hbm_bytes"]


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("name", FIXTURES)
def test_collective_sensitivity_equal(name, m):
    txt = text(name)
    t = sens_rows(T.collective_sensitivity(txt, axes(name), m=m))
    assert t == sens_rows(R.collective_sensitivity(txt, axes(name), m=m))
    if m == EXPECTED["config"]["sens_m"]:
        assert jsonable(t) == EXPECTED["hlo"][name]["collective_sensitivity"]


def test_collective_sensitivity_alpha_overrides_equal():
    txt = text("train")
    over = {"model": 3e-6, "data": 7e-6}
    assert sens_rows(T.collective_sensitivity(txt, SYNTH_AXES, alphas=over)) \
        == sens_rows(R.collective_sensitivity(txt, SYNTH_AXES, alphas=over))
    assert tsens.DEFAULT_ALPHAS == rsens.DEFAULT_ALPHAS


@pytest.mark.parametrize("name", FIXTURES)
def test_parse_hlo_equal(name):
    t, r = T.parse_hlo(text(name)), R.parse_hlo(text(name))
    assert list(t) == list(r)
    for c in r:
        assert t[c].is_entry == r[c].is_entry
        assert [(o.name, o.opcode, o.type_str, o.operands, o.attrs, o.line)
                for o in t[c].ops] == \
            [(o.name, o.opcode, o.type_str, o.operands, o.attrs, o.line)
             for o in r[c].ops]
        assert thlo.computation_multipliers(t) == \
            rhlo.computation_multipliers(r)


# ------------------------------------------------- tests/test_hlo.py cases

@pytest.mark.parametrize("s", ["f32[64,64]{1,0}", "bf16[2,3]",
                               "(f32[4]{0}, s32[2]{0})", "pred[8]",
                               "(s32[], f32[64,64])", "token[]",
                               "f8e4m3fn[3,5]", "c128[2]"])
def test_shape_bytes(s):
    assert T.shape_bytes(s) == R.shape_bytes(s)
    if s == "f32[64,64]{1,0}":
        assert T.shape_bytes(s) == 64 * 64 * 4


def test_parse_computations():
    comps = T.parse_hlo(text("synth"))
    assert set(comps) == {"add", "cond", "body", "main"}
    assert comps["main"].is_entry
    assert comps["main"].by_name["d"].opcode == "dot"


def test_trip_count_and_multipliers():
    mult = thlo.computation_multipliers(T.parse_hlo(text("synth")))
    assert mult["body"] == 7
    assert mult["main"] == 1


def test_collectives_per_axis():
    per = T.analyze_collectives(text("synth"), SYNTH_AXES)["per_axis"]
    assert per["model"]["count"] == 7
    assert per["model"]["bytes"] == 7 * 64 * 64 * 4
    assert per["model"]["depth"] == 7
    assert per["data"]["count"] == 1


def test_flops_estimate_trip_scaled():
    assert T.hlo_flops_estimate(text("synth")) == 2 * 64 * 128 * 64


@pytest.mark.parametrize("attrs,want", [
    ("replica_groups={{0,1,2,3}}", "model"),
    ("replica_groups={{0,4}}", "data"),
    ("replica_groups={{0,1}}", "model(sub)"),
    ("replica_groups=[8,1]<=[8]", "self"),
    ("source_target_pairs={{0,1},{1,2}}", "model(sub)"),
    ("replica_groups=[2,4]<=[4,2]T(1,0)", None),
    ("replica_groups={{0,3}}", None),
    ("channel_id=1", "unknown"),
])
def test_axis_classification_subgroups(attrs, want):
    tt = T.axis_signature_table(SYNTH_AXES)
    assert tt == R.axis_signature_table(SYNTH_AXES)
    got = thlo.classify_axis(attrs, tt)
    assert got == rhlo.classify_axis(attrs, R.axis_signature_table(
        SYNTH_AXES))
    if want is not None:
        assert got == want


def test_real_compiled_module_roundtrip():
    """A module jax compiles here, on one host device, through both
    packages."""
    import jax
    import jax.numpy as jnp

    def f(a, b):
        def body(c, _):
            return jnp.tanh(c @ b), None
        out, _ = jax.lax.scan(body, a, None, length=5)
        return out.sum()
    a = jnp.ones((32, 32))
    b = jnp.ones((32, 32))
    txt = jax.jit(f).lower(a, b).compile().as_text()
    flops = T.hlo_flops_estimate(txt)
    assert flops == R.hlo_flops_estimate(txt)
    assert flops >= 5 * 2 * 32 ** 3
    assert T.hlo_hbm_bytes_estimate(txt) == R.hlo_hbm_bytes_estimate(txt)
    assert T.hlo_hbm_bytes_estimate(txt) > 0
    stats = T.analyze_collectives(txt, [("data", 1)])
    assert stats == R.analyze_collectives(txt, [("data", 1)])
    assert stats["total"]["count"] == 0


# ----------------------------- the analysis half of test_dryrun_small.py

def test_dryrun_train_step_analysis():
    txt = text("train")
    coll = T.analyze_collectives(txt, SYNTH_AXES)
    assert coll["total"]["count"] > 0
    assert coll["multipliers"]
    assert any(v >= 3 for v in coll["multipliers"].values())
    from repro.configs import ARCHS
    from repro.models import get_model
    import dataclasses
    cfg = dataclasses.replace(ARCHS["qwen3-0.6b"].reduced(), n_layers=3,
                              d_model=128, n_heads=8, n_kv_heads=4,
                              head_dim=16, d_ff=256, vocab_size=512,
                              dtype="bfloat16")
    model_flops = 6 * get_model(cfg).n_params() * 8 * 64 / 8
    assert T.hlo_flops_estimate(txt) > 0.3 * model_flops
    assert T.hlo_hbm_bytes_estimate(txt) > 0
    sens = T.collective_sensitivity(txt, SYNTH_AXES)
    assert sens["per_axis"]["model"].D >= cfg.n_layers


def test_dryrun_decode_step_analysis():
    assert T.analyze_collectives(text("decode"),
                                 SYNTH_AXES)["total"]["count"] > 0


def test_per_axis_depth_runs_the_level_pass(monkeypatch):
    """Each per-axis depth is a ``mem_layers`` pass of the engine (on the
    card, the level kernel); ``_comp_edag`` builds the port's ``EDag``."""
    from repro_torch.core.graph import EDag
    calls = []
    orig = EDag.mem_layers

    def spy(self, is_mem=None):
        calls.append(is_mem is not None)
        return orig(self, is_mem)
    monkeypatch.setattr(EDag, "mem_layers", spy)
    T.analyze_collectives(text("synth"), SYNTH_AXES)
    # two computations hold collectives: main (data) and body (model)
    assert calls.count(False) == 2 and calls.count(True) == 2
