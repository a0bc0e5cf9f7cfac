"""The port's sharding rules (``repro_torch.sharding``), logical axes and
meshes against the reference package on the CPU: every case of
``test_sharding.py`` through the port; for every config of ``ARCHS`` and
the single-pod (16, 16) and multi-pod (2, 16, 16) meshes, every parameter
leaf's spec, with the family's ``rules_override`` merged, equal to the
reference's, and the train step's spec trees too; ``batch_axes_for`` and
``decode_cache_rules`` over a grid of batch sizes and sequence lengths;
the logical-axis trees and rule overrides; and the device-free meshes."""
import jax
import pytest
from jax.sharding import PartitionSpec as RefP

from repro.configs import ARCHS as REF_ARCHS
from repro.models import get_model as ref_model
from repro.models.module import logical_axes as ref_logical_axes
from repro.sharding import rules as ref_rules
from repro.train.train_loop import shardings_for_train as ref_shardings
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh, mesh_axis_sizes)
from repro_torch.models import get_model
from repro_torch.models.module import logical_axes
from repro_torch.sharding import (DEFAULT_RULES, PartitionSpec as P,
                                  batch_axes_for, constrain, current_mesh,
                                  decode_cache_rules, param_partition_specs,
                                  sharding_ctx, spec_for)
from repro_torch.train.train_loop import shardings_for_train


class FakeMesh:
    """Axis-name/shape stand-in (spec_for only reads names + sizes)."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = shape


POD = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})


# ------------------------------------------ the cases of test_sharding.py

def test_param_spec_basic():
    # (d, H, hd) with heads divisible by model
    s = spec_for((8192, 64, 128), ("embed", "heads", "head_dim"), POD)
    assert s == P("data", "model")


def test_kv_heads_replicated_when_indivisible():
    s = spec_for((8192, 8, 128), ("embed", "kv_heads", "head_dim"), POD)
    assert s == P("data")          # 8 kv heads % 16 -> replicated


def test_no_axis_reuse_within_spec():
    # batch and kv_seq both want axes; model goes to kv_seq, data to batch
    s = spec_for((128, 32768), ("batch", "kv_seq"), POD)
    assert s == P("data", "model")


def test_vocab_padding_divisible():
    s = spec_for((92560, 2048), ("vocab", "embed"), POD)
    assert s == P("model", "data")


def test_batch_axes_for():
    assert batch_axes_for(256, MULTI) == ("pod", "data")
    assert batch_axes_for(32, MULTI) == ("pod", "data")
    assert batch_axes_for(8, MULTI) == ("pod",)    # 8 % (2*16) != 0
    assert batch_axes_for(1, MULTI) == ()
    assert batch_axes_for(128, POD) == ("data",)


def test_decode_cache_rules_long_context():
    """long_500k (batch 1): every axis goes to the KV sequence dim."""
    r = decode_cache_rules(1, 524288, MULTI)
    assert r["batch"] == ()
    assert r["kv_seq"] == ("pod", "data", "model")
    r2 = decode_cache_rules(128, 32768, POD)
    assert r2["batch"] == ("data",)
    # batched decode: heads (or head_dim) take 'model'; seq stays unsharded
    assert r2["kv_seq"] == ()
    assert r2["kv_heads"] == ("model",)


def test_multi_axis_batch_spec():
    s = spec_for((256, 4096), ("batch", "seq"), MULTI)
    assert s == P(("pod", "data"))


def test_trailing_nones_trimmed():
    s = spec_for((64, 128, 16), ("embed", None, None),
                 FakeMesh({"data": 16, "model": 16}))
    assert s == P("data")


# ------------------------------------------------------ the reference

MESHES = {"pod": POD, "multi": MULTI}


def _ref_table(tree) -> dict:
    """{path: spec entries} of the reference's PartitionSpec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefP))[0]
    return {"/".join(str(k.key) for k in path): tuple(s) for path, s in flat}


def _table(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_table(v, prefix + k + "/"))
        else:
            assert isinstance(v, P)
            out[prefix + k] = tuple(v)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_equal_reference(name, mesh):
    """Every parameter leaf of every config, rules_override merged."""
    api, rapi = get_model(ARCHS[name]), ref_model(REF_ARCHS[name])
    assert api.rules_override() == rapi.rules_override()
    rules = {**DEFAULT_RULES, **api.rules_override()}
    got = _table(param_partition_specs(api.specs(), MESHES[mesh], rules))
    want = _ref_table(ref_rules.param_partition_specs(
        rapi.specs(), MESHES[mesh], {**ref_rules.DEFAULT_RULES,
                                     **rapi.rules_override()}))
    assert got == want
    assert any(e is not None for spec in got.values() for e in spec)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "mixtral-8x7b",
                                  "qwen3-0.6b"])
def test_train_shardings_equal_reference(name):
    api, rapi = get_model(ARCHS[name]), ref_model(REF_ARCHS[name])
    extra = {"mlp": ()}
    pspecs, opt_specs, merged = shardings_for_train(api, MULTI, extra)
    rp, ropt, rmerged = ref_shardings(rapi, MULTI, extra)
    assert merged == rmerged
    assert _table(pspecs) == _ref_table(rp)
    assert _table(opt_specs.mu) == _ref_table(ropt.mu)
    assert opt_specs.step == P() and tuple(ropt.step) == ()


def test_ep_rules_equal_reference():
    import dataclasses
    for name in ("granite-moe-1b-a400m", "mixtral-8x7b"):
        for par in ("tp", "ep"):
            cfg = dataclasses.replace(ARCHS[name], moe_parallelism=par)
            rcfg = dataclasses.replace(REF_ARCHS[name], moe_parallelism=par)
            assert get_model(cfg).rules_override() == \
                ref_model(rcfg).rules_override()
    assert get_model(dataclasses.replace(
        ARCHS["granite-moe-1b-a400m"], moe_parallelism="ep")
    ).rules_override() == {"expert": ("model",), "mlp": ()}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_logical_axes_equal_reference(name):
    got = logical_axes(get_model(ARCHS[name]).specs())
    want = ref_logical_axes(ref_model(REF_ARCHS[name]).specs())

    def flat(t, prefix=""):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + k + "/"))
            else:
                out[prefix + k] = tuple(v)
        return out
    assert flat(got) == flat(want)


def test_batch_and_decode_rules_equal_reference():
    meshes = [POD, MULTI, FakeMesh({"data": 4, "model": 2}),
              FakeMesh({"data": 1, "model": 1})]
    for mesh in meshes:
        for B in (1, 2, 3, 8, 16, 24, 32, 64, 128, 256, 1024):
            assert batch_axes_for(B, mesh) == ref_rules.batch_axes_for(B,
                                                                       mesh)
            for T in (1, 8, 100, 4096, 32768, 524288):
                assert decode_cache_rules(B, T, mesh) == \
                    ref_rules.decode_cache_rules(B, T, mesh)


# ------------------------------------------------------ meshes, context

def test_meshes():
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert mesh_axis_sizes(pod) == [("data", 16), ("model", 16)]
    assert mesh_axis_sizes(multi) == [("pod", 2), ("data", 16),
                                      ("model", 16)]
    assert make_host_mesh().shape == {"data": 1, "model": 1}
    assert spec_for((8192, 64), ("embed", "heads"), pod) == \
        tuple(ref_rules.spec_for((8192, 64), ("embed", "heads"), POD))
    host = make_host_mesh()
    got = _table(param_partition_specs(
        get_model(ARCHS["qwen3-0.6b"]).specs(), host))
    assert got == _ref_table(ref_rules.param_partition_specs(
        ref_model(REF_ARCHS["qwen3-0.6b"]).specs(), FakeMesh(host.shape)))


def test_sharding_ctx_and_constrain():
    mesh = Mesh({"data": 2, "model": 4})
    assert current_mesh() is None
    with sharding_ctx(mesh, {"heads": ()}):
        assert current_mesh() is mesh
        with sharding_ctx(None):
            assert current_mesh() is None
        assert current_mesh() is mesh
    assert current_mesh() is None
    import torch
    x = torch.zeros(3)
    with sharding_ctx(mesh):
        assert constrain(x, "batch") is x
    assert P("a", None) == ("a", None) and P() == () and \
        repr(P("a")) == "PartitionSpec('a',)"
