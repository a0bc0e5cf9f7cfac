"""The MoE layer's multi-rank paths (``repro_torch.models.moe`` under a
``RankMesh``) on 8 ``gloo`` ranks on the CPU, against the reference's
``shard_map`` paths on 8 host devices (``tests/test_moe_parallel.py``'s
case: reduced granite, d 64, d_ff 32, 8 experts, top-2, capacity factor 8,
here from seeded numpy inputs and weights).

Both run once, side by side, in child processes
(``repro_torch.launch.moe_parallel --case equivalence``; a JAX script
that fakes 8 devices).  For "tp", "ep" and "tp" + ``moe_scatter_out`` on
the (2, 4) mesh:

* the output equals the single-rank output within 1e-4 (capacity factor 8
  admits every pair on every rank's block);
* each rank's block of the output equals the reference's shard on the
  device at its mesh coordinates within 1e-5, and the aux loss the
  reference's;
* the gradient of ``y.sum()`` with respect to the input and every weight
  equals the reference's ``jax.grad`` on the same mesh within 1e-4, and
  the reference's equals its single-device gradient: ``shard_map``'s
  transposes (the ``psum`` of a ``psum``'s cotangent, the out-cotangent
  divided over the axes an output's spec leaves out, the in-cotangent
  summed over them) leave no scale of an axis's size.

At capacity factor 1 ("tp" and "ep"), where a rank's block drops pairs
that one rank keeps, the outputs and gradients still equal the
reference's.  Under a ``Mesh`` with no process group behind it the layer
runs the single-rank path: the same bits, no collective.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.launch.moe_parallel import (DROP_MODES, MODES, WEIGHTS,
                                             launch)

ROOT = Path(__file__).resolve().parents[1]
TAGS = [t for t, _ in MODES]
ALL_TAGS = TAGS + [t for t, _ in DROP_MODES]
MESH = (2, 4)

_JAX = textwrap.dedent('''
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import ARCHS
    from repro.models import moe
    from repro.sharding.rules import sharding_ctx
    from repro.launch.mesh import auto_axis_types_kwargs
    from repro_torch.launch.moe_parallel import (equivalence_case, MODES,
                                                 DROP_MODES)
    _, x_np, wb_np = equivalence_case()
    cfg = dataclasses.replace(ARCHS["granite-moe-1b-a400m"].reduced(),
                              d_model=64, d_ff=32, n_experts=8, top_k=2,
                              capacity_factor=8.0)
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         **auto_axis_types_kwargs(2))
    x = jnp.asarray(x_np)
    wb = {k: jnp.asarray(v) for k, v in wb_np.items()}
    out = {}
    def run(tag, c, m):
        f = lambda x, w: moe.moe_ffn(x, w, c)
        g = jax.grad(lambda x, w: f(x, w)[0].sum(), argnums=(0, 1))
        with sharding_ctx(m):
            y, aux = jax.jit(f)(x, wb)
            gx, gw = jax.jit(g)(x, wb)
        if m is not None:
            for i, j in np.ndindex(m.devices.shape):
                sh = [s for s in y.addressable_shards
                      if s.device == m.devices[i, j]][0]
                out[f"shard_{tag}_{i}_{j}"] = np.asarray(sh.data)
        out[f"y_{tag}"] = np.asarray(y)
        out[f"aux_{tag}"] = np.asarray(aux)
        out[f"g_{tag}_x"] = np.asarray(gx)
        for k in gw:
            out[f"g_{tag}_{k}"] = np.asarray(gw[k])
    run("single", cfg, None)
    for tag, knob in MODES + DROP_MODES:
        run(tag, dataclasses.replace(cfg, **knob), mesh)
    np.savez(sys.argv[1], **out)
''')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 8 ranks' results, the reference's), both computed at once."""
    out = tmp_path_factory.mktemp("moe_parallel")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _JAX,
                            str(out / "jax.npz")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        rcs = launch("equivalence", str(out), device="cpu", timeout=240)
        log, _ = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert rcs == [0] * 8, rcs
    assert ref.returncode == 0, log
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(8)]
    return ranks, dict(np.load(out / "jax.npz"))


def _block(y, tag, coords):
    """The block of the global ``y`` at mesh ``coords`` under the
    reference's ``out_specs``: the batch over data; the sequence over model
    for "ep" and the scatter."""
    d, m = coords
    B, T = y.shape[:2]
    b = y[d * B // MESH[0]:(d + 1) * B // MESH[0]]
    if tag.startswith("ep") or tag == "tp_scatter":
        b = b[:, m * T // MESH[1]:(m + 1) * T // MESH[1]]
    return b


def test_ranks_sit_on_the_mesh_in_row_major_order(runs):
    ranks, _ = runs
    assert [tuple(r["coords"]) for r in ranks] == \
        [(d, m) for d in range(2) for m in range(4)]
    assert all(str(r["device"]) == "cpu" for r in ranks)


@pytest.mark.parametrize("tag", TAGS)
def test_equals_the_single_rank_output(runs, tag):
    ranks, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r[f"y_{tag}"], r["y_single"], rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("tag", ALL_TAGS)
def test_each_rank_block_is_the_references_shard(runs, tag):
    ranks, ref = runs
    for r in ranks:
        d, m = r["coords"]
        np.testing.assert_allclose(_block(r[f"y_{tag}"], tag, (d, m)),
                                   ref[f"shard_{tag}_{d}_{m}"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(r[f"y_{tag}"], ref[f"y_{tag}"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(r[f"aux_{tag}"], ref[f"aux_{tag}"],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tag", ALL_TAGS)
@pytest.mark.parametrize("name", ("x",) + WEIGHTS)
def test_gradients_are_the_references(runs, tag, name):
    ranks, ref = runs
    for r in ranks:
        np.testing.assert_allclose(r[f"g_{tag}_{name}"],
                                   ref[f"g_{tag}_{name}"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("name", ("x",) + WEIGHTS)
def test_reference_gradients_carry_no_axis_scale(runs, tag, name):
    """Without drops the reference's gradients on the mesh are its
    single-device gradients: what the port is held to above."""
    _, ref = runs
    np.testing.assert_allclose(ref[f"g_{tag}_{name}"],
                               ref[f"g_single_{name}"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("tag", [t for t, _ in DROP_MODES])
def test_capacity_is_per_rank_block(runs, tag):
    """At capacity factor 1 the ranks' blocks drop pairs one rank keeps:
    the output moves off the single-rank output (and is the reference's,
    above)."""
    ranks, ref = runs
    assert np.abs(ranks[0][f"y_{tag}"] - ranks[0]["y_single"]).max() > 1e-3
    assert np.abs(ref[f"y_{tag}"] - ref["y_single"]).max() > 1e-3


def test_single_rank_output_is_the_references(runs):
    ranks, ref = runs
    np.testing.assert_allclose(ranks[0]["y_single"], ref["y_single"],
                               rtol=0, atol=1e-5)


def test_mesh_without_groups_takes_the_local_path(runs):
    ranks, _ = runs
    for r in ranks:
        np.testing.assert_array_equal(r["y_groupless"], r["y_single"])
        for name in ("x",) + WEIGHTS:
            np.testing.assert_array_equal(r[f"g_groupless_{name}"],
                                          r[f"g_single_{name}"])
        assert int(r["collectives_without_groups"]) == 0


def test_collectives_are_the_references(runs):
    """Per rank, over the five runs' forwards and the backwards of
    ``y.sum()`` (the aux is not in it, so its ``pmean`` runs forward
    only): "tp" one ``all_reduce`` (the ``psum``) each way and one for the
    aux; the scatter a ``reduce_scatter`` forward and its ``all_gather``
    backward instead of the ``psum``; "ep" two ``all_to_all``s each way;
    each call's input and four weights sharded once and their gradients
    summed once (``shard``), its output gathered once (``assemble``), and
    the input block of "tp" and the scatter broadcast once over the ranks
    that share it."""
    ranks, _ = runs
    counts = json.loads(str(ranks[0]["counts"]))
    tp, scatter, ep = 2 + 1, 1, 1           # all_reduces of each run
    assert counts["all_reduce"][0] == 2 * tp + scatter + 2 * ep
    assert counts["all_to_all_single"][0] == 2 * (2 + 2)
    assert counts["reduce_scatter_tensor"][0] == 1
    assert counts["all_gather_into_tensor"][0] == 1
    assert counts["shard"][0] == 5 * 5
    assert counts["assemble"][0] == 5
    assert counts["broadcast"][0] == 3                  # tp, tp_drop, scatter


def test_prefill_case_rehearses_on_the_cpu(tmp_path):
    """``chip_smoke.py`` phase "moe" (b) at the reduced config on 4 ranks
    of the host (float32): every MoE block of "tp", the scatter and "ep"
    within ``PREFILL_TOL`` of the single-rank block on the same input, no
    pair dropped at the reduced config's own capacity factor 4, and the
    collectives of each path."""
    from repro_torch.launch.moe_parallel import PREFILL_TOL
    assert launch("prefill", str(tmp_path), device="cpu", timeout=240,
                  reduced=True) == [0] * 4
    ranks = [json.loads((tmp_path / f"prefill_rank{r}.json").read_text())
             for r in range(4)]
    L = ranks[0]["config"]["n_layers"]
    for rep in ranks:
        for tag in TAGS:
            row = rep[tag]
            assert row["finite"] and row["blocks_checked"] == L
            assert row["worst_block_rel_err"] <= PREFILL_TOL
            assert row["logits_rel_err"] < 1e-4
        assert rep["ep"]["dropped_pairs_own_capacity"] == {"single": 0,
                                                           "ep": 0}
        assert set(rep["tp"]["collectives_per_layer"]) == {"all_reduce",
                                                           "broadcast"}
        assert "all_to_all_single" in rep["ep"]["collectives_per_layer"]
        assert "reduce_scatter_tensor" in \
            rep["tp_scatter"]["collectives_per_layer"]
        assert rep["single"]["collectives_per_layer"] == {}
