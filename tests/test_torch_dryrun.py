"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU, against
the reference package's.

* Every cell of ``configs/dryrun_expected.json`` (``tools/
  dryrun_expected.py``: the reference's ``run_cell`` and its compiled
  text): ``skipped``, the HLO frontend's collectives, per-axis lambda,
  FLOPs and bytes, the model FLOPs, and XLA's argument, alias and output
  bytes equal the reference's; the argument and alias bytes are also the
  sums of the reference's own ``param_partition_specs`` shards, divided as
  its ``_shard_shape`` divides, with nothing compiled.
* ``test_dryrun_small.py``'s assertions on the port's dry-run of the
  (2, 4) mesh's train and decode steps (``configs/hlo/{train,decode}``).
* ``test_system.py::test_dryrun_artifacts_schema``'s assertions on
  artifacts the port writes; ``--table``; the live-bytes counter on a
  sequence of operations whose peak is known; rematerialisation in the
  per-device step; the train launcher's message.
"""
import dataclasses
import functools
import gzip
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import Mesh, make_production_mesh

CONFIGS = Path(D.__file__).resolve().parents[1] / "configs"
EXPECTED = json.loads((CONFIGS / "dryrun_expected.json").read_text())
CELLS = sorted(EXPECTED["cells"])
EQUAL_KEYS = ("hlo_flops_per_device", "hlo_bytes_per_device",
              "collectives", "per_axis_lambda", "model_flops_global",
              "model_flops_per_device", "useful_flops_ratio")
MEMORY_KEYS = ("argument_size_in_bytes", "alias_size_in_bytes",
               "output_size_in_bytes")


@pytest.fixture(autouse=True)
def _on_the_host(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")


def jsonable(x):
    return json.loads(json.dumps(x))


# ------------------------------------------------------------ fixture cells

def test_fixtures_are_the_recorded_ones_and_small():
    total = 0
    for name in CELLS:
        e = EXPECTED["cells"][name]
        path = D.FIXTURES / f"{name}.hlo.gz"
        if "skipped" in e["artifact"]:
            assert not path.exists()
            continue
        total += path.stat().st_size
        assert len(gzip.decompress(path.read_bytes())) == e["text_bytes"]
    assert total == EXPECTED["gz_total_bytes"] < 1_000_000
    assert len(CELLS) == 9


@pytest.mark.parametrize("name", CELLS)
def test_cell_equals_reference(name):
    e = EXPECTED["cells"][name]
    want = e["artifact"]
    got = D.run_cell(e["arch"], e["shape"], e["mesh"], step=False)
    if "skipped" in want:
        assert got == want
        return
    for key in EQUAL_KEYS:
        assert jsonable(got[key]) == want[key], key
    for key in MEMORY_KEYS:
        assert got["memory_analysis"][key] == \
            want["memory_analysis"][key], key
    assert got["n_devices"] == want["n_devices"]
    assert got["roofline"]["source"] == "hlo"
    assert got["roofline"]["dominant"] in ("compute", "memory", "collective")


def _shard_shape(shape, pspec, mesh):
    """The reference's ``dryrun.py:160 _shard_shape``."""
    dims = list(shape)
    for i, entry in enumerate(pspec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            dims[i] //= mesh.shape[ax]
    return tuple(dims)


def reference_shard_sums(arch, shape_name, mesh_kind, skip):
    """(argument, alias) bytes from the reference's own specs and
    ``param_partition_specs``, less the inputs the step never reads
    (``skip``, the port's ``unused_inputs`` paths), compiling nothing."""
    import numpy as np
    from repro.models import get_model
    from repro.models.module import abstract_params
    from repro.sharding import param_partition_specs
    from repro.sharding.rules import (DEFAULT_RULES, decode_cache_rules,
                                      spec_for)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    shape = SHAPES[shape_name]
    api = get_model(ARCHS[arch])
    rules = dict(DEFAULT_RULES)
    rules.update(api.rules_override())
    if shape.kind == "decode":
        rules.update(decode_cache_rules(shape.global_batch, shape.seq_len,
                                        mesh))

    def tree_bytes(specs, prefix, itemsize=None):
        pspecs = param_partition_specs(specs, mesh, rules)
        total = 0
        for (path, sds), (_, sp) in zip(
                jax.tree_util.tree_leaves_with_path(abstract_params(specs)),
                jax.tree_util.tree_leaves_with_path(
                    pspecs, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))):
            key = prefix + tuple(k.key for k in path)
            if key in skip:
                continue
            total += int(np.prod(_shard_shape(sds.shape, sp, mesh))) * \
                (itemsize or jnp.dtype(sds.dtype).itemsize)
        return total

    sds, logical = api.input_specs(shape)
    batch = sum(int(np.prod(_shard_shape(
        sds[k].shape, spec_for(sds[k].shape, logical[k], mesh, rules),
        mesh))) * jnp.dtype(sds[k].dtype).itemsize
        for k in sds if ("batch", k) not in skip)
    params = tree_bytes(api.specs(), ("params",))
    if shape.kind == "train":
        state = params + 2 * tree_bytes(api.specs(), ("params",), 4) + 4
        return state + batch, state
    cache = tree_bytes(api.cache_specs(shape), ("cache",))
    if shape.kind == "prefill":
        return params + batch, 0
    return params + cache + batch, cache


@pytest.mark.parametrize("name", [n for n in CELLS if "skipped" not in
                                  EXPECTED["cells"][n]["artifact"]])
def test_argument_and_alias_are_the_references_shard_sums(name):
    e = EXPECTED["cells"][name]
    skip = D.unused_inputs(ARCHS[e["arch"]], SHAPES[e["shape"]].kind)
    arg, alias = reference_shard_sums(e["arch"], e["shape"], e["mesh"], skip)
    mem = e["artifact"]["memory_analysis"]
    assert (arg, alias) == (mem["argument_size_in_bytes"],
                            mem["alias_size_in_bytes"])


def test_unused_inputs_are_the_ones_jit_drops():
    """An RWKV6 decode step never reads its position, an
    encoder-decoder's decode step no encoder weight and no cross-attention
    projection (its cross K/V come from the cache); a train step reads
    every input."""
    rwkv = D.unused_inputs(ARCHS["rwkv6-7b"], "decode")
    assert rwkv == {("batch", "cur_index")}
    enc = D.unused_inputs(ARCHS["seamless-m4t-large-v2"], "decode")
    assert ("params", "enc_ln_f") in enc
    assert ("params", "dec_blocks", "x_wk") in enc
    assert not any(p[:2] == ("params", "embed") for p in enc)
    assert D.unused_inputs(ARCHS["qwen3-0.6b"], "train") == frozenset()


# ------------------------------------------------- the small mesh's steps

SMALL = dict(n_layers="3", d_model="128", n_heads="8", n_kv_heads="4",
             head_dim="16", d_ff="256", vocab_size="512", dtype="bfloat16")
SMALL_MESH = Mesh({"data": 2, "model": 4})


def small_text(name):
    return gzip.decompress((CONFIGS / "hlo" / f"{name}.hlo.gz")
                           .read_bytes()).decode()


def small_cfg(remat):
    return dataclasses.replace(ARCHS["qwen3-0.6b"], remat=remat, **{
        k: (v if k == "dtype" else int(v)) for k, v in SMALL.items()})


@functools.lru_cache(maxsize=None)
def small_train_step(remat):
    """The per-device train step of the (2, 4) mesh, batch 8 x 64, under
    ``remat``, shared by the tests that read it."""
    from repro_torch.sharding.rules import DEFAULT_RULES
    return D.per_device_step(small_cfg(remat), ShapeConfig("t", 64, 8,
                                                          "train"),
                             SMALL_MESH, DEFAULT_RULES, n_params=1)


def test_small_mesh_train_step():
    """``test_dryrun_small.py``'s train-step assertions on the port's
    dry-run of the same step (the (2, 4) mesh, batch 8 x 64)."""
    from repro_torch.models import get_model
    res = D.run_cell("qwen3-0.6b", ShapeConfig("t", 64, 8, "train"),
                     SMALL_MESH, overrides=SMALL,
                     hlo_text=small_text("train"), step=False)
    st = small_train_step("block")
    coll = res["collectives"]
    assert coll["total"]["count"] > 0
    assert coll["multipliers"]
    assert any(v >= 3 for v in coll["multipliers"].values())
    cfg = small_cfg("block")
    model_flops = 6 * get_model(cfg).n_params() * 8 * 64 / 8
    assert res["hlo_flops_per_device"] > 0.3 * model_flops
    assert res["hlo_bytes_per_device"] > 0
    assert res["per_axis_lambda"]["model"]["D"] >= cfg.n_layers
    assert st["temp_bytes"] > 0
    assert st["flops"] > 0.3 * model_flops


def test_small_mesh_decode_step():
    res = D.run_cell("qwen3-0.6b", ShapeConfig("d", 64, 8, "decode"),
                     SMALL_MESH, overrides=SMALL,
                     hlo_text=small_text("decode"))
    assert res["collectives"]["total"]["count"] > 0
    assert res["memory_analysis"]["temp_size_in_bytes"] > 0


# ---------------------------------------------------------------- artifacts

def test_artifacts_schema(tmp_path, capsys):
    """``test_system.py::test_dryrun_artifacts_schema`` on artifacts the
    port writes, and the roofline report over them."""
    for cell in (["qwen3-0.6b", "decode_32k", "pod"],
                 ["rwkv6-7b", "long_500k", "pod"],
                 ["qwen3-0.6b", "long_500k", "pod"]):
        assert D.main(["--cell", *cell, "--out", str(tmp_path)]) == 0
    checked = 0
    for path in sorted(tmp_path.glob("*.json")):
        d = json.loads(path.read_text())
        if "skipped" in d or "error" in d:
            continue
        for key in ("roofline", "collectives", "hlo_flops_per_device",
                    "memory_analysis", "per_axis_lambda"):
            assert key in d, (path, key)
        assert d["roofline"]["dominant"] in ("compute", "memory",
                                             "collective")
        assert d["fits_hbm"] is True
        assert d["memory_analysis"]["temp_size_in_bytes"] > 0
        checked += 1
    assert checked == 2
    capsys.readouterr()
    assert D.main(["--table", "--out", str(tmp_path)]) == 0
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows[0].startswith("arch,shape,mesh,fits,compute_s")
    assert [r.split(",")[:3] for r in rows[1:3]] == [
        ["qwen3-0.6b", "decode_32k", "pod"], ["rwkv6-7b", "long_500k", "pod"]]
    assert all(r.split(",")[8] == "hlo" for r in rows[1:3])
    assert rows[-1].startswith("# worst roofline fraction")


def test_table_without_artifacts(tmp_path):
    assert D.table(tmp_path) == ["# no dry-run artifacts; run: python -m "
                                 "repro_torch.launch.dryrun --all"]


def test_variant_has_no_compiled_text(tmp_path):
    """A variant reads no fixture: the roofline comes from the per-device
    step's counts and has no collective term."""
    res = D.run_cell("rwkv6-7b", "long_500k", "pod", bf16_params=True)
    assert res["collectives"] is None and res["per_axis_lambda"] is None
    assert res["roofline"]["source"] == "torch"
    assert res["roofline"]["collective_s"] is None
    assert res["useful_flops_ratio"] > 0


def test_h100_rates():
    from repro_torch.configs import HW
    assert HW == {"peak_flops_bf16": 989e12, "peak_flops_f32": 67e12,
                  "hbm_bw": 3.35e12, "nvlink_bw_per_gpu": 450e9,
                  "hbm_bytes": 80e9}


# -------------------------------------------------------------- live bytes

def test_live_bytes_known_peak():
    """Three float32 vectors of 1000 (4000 bytes each), one freed before
    the third is made, a view, an in-place update: the peak is 12000
    bytes, two storages live at the end."""
    a = torch.empty(1000, device="meta")
    meter = D.LiveBytes()
    meter.track(a)
    with meter:
        b = a + 1                       # a, b: 8000
        c = b * 2                       # a, b, c: 12000 (peak)
        v = c[:500]                     # a view: no new storage
        del b
        v.add_(1)                       # in place: nothing new
        d = a - 1                       # a, c, d: 12000
        del c, v
        e = d.sum()                     # a, d, e: 8004
    meter.sweep()
    assert meter.peak == 12000
    assert meter.current == 8004 and len(meter.live) == 3
    assert d.untyped_storage()._cdata in meter.live and e.numel() == 1
    # every operation's inputs and outputs but the view's
    assert meter.accessed == (8000 + 8000 + 4000 + 8000 + 4004)


def test_live_bytes_counts_saved_activations():
    """A tensor autograd keeps for the backward stays live after its
    Python object is gone."""
    w = torch.empty(256, 256, device="meta", requires_grad=True)
    meter = D.LiveBytes()
    with meter:
        h = torch.tanh(w @ w)           # saved by tanh's backward
        out = h.sum()
        del h
        torch.empty(1, device="meta")   # a later allocation sweeps
        assert meter.current >= 256 * 256 * 4
        out.backward()


# ------------------------------------------------------ the per-device step

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b"])
def test_rematerialisation_in_the_per_device_step(arch):
    """Per-block rematerialisation, as the reference's train cells assume:
    the per-device step keeps less and computes more with it than
    without (qwen3-0.6b on the small mesh's step, rwkv6-7b reduced to 4
    layers on a (2, 2) mesh)."""
    from repro_torch.sharding.rules import DEFAULT_RULES
    if arch == "qwen3-0.6b":
        block, none = small_train_step("block"), small_train_step("none")
    else:
        base = dataclasses.replace(ARCHS[arch].reduced(), n_layers=4)
        mesh = Mesh({"data": 2, "model": 2})
        shape = ShapeConfig("t", 64, 8, "train")
        block, none = (D.per_device_step(dataclasses.replace(base, remat=r),
                                         shape, mesh, DEFAULT_RULES,
                                         n_params=1)
                       for r in ("block", "none"))
    assert block["input_bytes"] == none["input_bytes"]
    assert block["temp_bytes"] < none["temp_bytes"]
    assert block["flops"] > none["flops"]


def test_per_device_shapes():
    """qwen3-0.6b's train cell on the pod: batch over data, query heads,
    the FFN and the vocabulary over model; 8 kv heads do not divide 16 and
    stay whole, then shrink to the local query head (GQA)."""
    from repro_torch.sharding.rules import DEFAULT_RULES
    local, lshape = D.per_device(ARCHS["qwen3-0.6b"], SHAPES["train_4k"],
                                 make_production_mesh(), DEFAULT_RULES)
    assert (local.n_heads, local.n_kv_heads, local.d_ff,
            local.padded_vocab(), local.d_model) == (1, 1, 192, 9504, 1024)
    assert (lshape.global_batch, lshape.seq_len) == (16, 4096)
    assert math.prod(make_production_mesh().shape.values()) == 256


def test_train_launcher_points_at_the_dry_run():
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match="repro_torch.launch.dryrun --cell"):
        train.main(["--production-mesh", "--reduced", "--device", "cpu"])
