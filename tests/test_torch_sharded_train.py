"""The sharded train step (``repro_torch.train.train_loop.jit_train_step``
on ``torch.distributed`` ranks) against the reference's ``jit_train_step``
on 8 host devices, on the CPU.

* ``sharding.rules.named_sharding``'s blocks equal the reference's
  ``NamedSharding.devices_indices_map`` for every parameter of each of the
  six families, on the (2, 4) mesh and on both production meshes (a JAX
  child process faking 512 devices).
* 8 ``gloo`` ranks on (2, 4) (``python -m repro_torch.launch.sharded
  --case fixture --checks``) run every case of
  ``configs/shard_expected.json`` (``tools/shard_expected.py``: qwen3,
  granite-moe, rwkv6, internvl2 with its ``prefix_embeds``, zamba2 and
  seamless with its ``frame_embeds``), each on the tensor-parallel path:
  the first step's loss within 1e-5 relative and its gradient norm and
  first moments within ``TOL``, every loss and learning rate within 1e-5,
  the gradient norms and each rank's shard of every parameter and AdamW
  moment within ``TOL``, but where ``DRIFT_BOUNDS`` widens them from the
  reference's own drift (ROADMAP §C 19).  The same runs equal the port's
  single-rank ``make_train_step`` to the same tolerances, but for the MoE
  case: there the reference's own mesh run is not its single-device run
  (its ``shard_map`` takes the capacity and the load-balancing term per
  block of tokens), and the port follows the mesh run.
* On that path no rank gathers a leaf over ``model``: the FSDP gathers
  move each rank's ``data`` block of its ``model`` shard, once per use.
* A batch with an uneven ``mask``: the loss is the global token mean, as
  the single-rank step's.
* The sum over ``model`` of a replicated leaf's gradient dropped
  (``collectives.sum_unnamed`` monkeypatched in the ranks), and zamba2's
  gated norm without its sum over ``model`` (``parallel._norm_sum``), are
  caught.
* A layout whose heads do not split over ``model`` takes the generic path
  and equals one rank; ``path_for`` names the path of every family.
* Step 1's gradient on the ranks (``launch.sharded.first_grads``) equals
  one process's, leaf by leaf.
* A checkpoint written at step 2 by the ranks resumes on one rank, and
  one written by one rank resumes on the ranks (through the launcher,
  ``--ranks 8 --model-parallel 4``), each equal at step 3 to the
  uninterrupted single-rank run.
* The launcher with ``--ranks 1`` prints what it printed before.
* One live child process runs the tool's first case, so that the
  fixture cannot go stale.

Every child process runs in the module's fixture (~50 s on 8 cores): the
two JAX children beside the 8 ranks of the fixture case, then the
launcher's 8 ranks."""
import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, TrainConfig
from repro_torch.data import SyntheticLMData
from repro_torch.launch import sharded as S
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import Mesh
from repro_torch.models import get_model
from repro_torch.models.module import (init_params_numpy, params_from_numpy,
                                       tree_leaves)
from repro_torch.models.parallel import path_for, rank_rows
from repro_torch.sharding import named_sharding, param_partition_specs
from repro_torch.sharding.rules import DEFAULT_RULES, spec_axes
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_loop import (flatten_specs, jit_train_step,
                                          make_train_step,
                                          shardings_for_train)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import shard_expected as SE  # noqa: E402

EXPECTED = json.loads((ROOT / "src" / "repro_torch" / "configs" /
                       "shard_expected.json").read_text())
#: one config of each family (the six of ``models.tracing.ZOO``)
FAMILIES = ("qwen3-0.6b", "granite-moe-1b-a400m", "internvl2-2b",
            "rwkv6-7b", "zamba2-7b", "seamless-m4t-large-v2")
MESHES = {"host_2x4": {"data": 2, "model": 4},
          "pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}
CASE_NAMES = [SE.case_name(*c) for c in SE.CASES]

_JAX = textwrap.dedent('''
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import ARCHS
    from repro.launch.mesh import auto_axis_types_kwargs
    from repro.models import get_model
    from repro.sharding import param_partition_specs
    from repro.sharding.rules import DEFAULT_RULES
    families, meshes = json.loads(sys.argv[1])

    def flat(tree, path=()):
        if isinstance(tree, dict):
            return {k2: v2 for k in sorted(tree)
                    for k2, v2 in flat(tree[k], path + (k,)).items()}
        return {"/".join(path): tree}
    devs = jax.devices()
    out = {}
    for mname, shape in meshes.items():
        n = int(np.prod(list(shape.values())))
        mesh = jax.sharding.Mesh(np.asarray(devs[:n]).reshape(
            tuple(shape.values())), tuple(shape),
            **auto_axis_types_kwargs(len(shape)))
        for arch in families:
            api = get_model(ARCHS[arch])
            rules = dict(DEFAULT_RULES, **api.rules_override())
            specs = flat(api.specs())
            pspecs = flat(param_partition_specs(api.specs(), mesh, rules))
            rec = {}
            for key, spec in pspecs.items():
                shp = specs[key].shape
                m = NamedSharding(mesh, spec).devices_indices_map(shp)
                rec[key] = [[[sl.start or 0, shp[i] if sl.stop is None
                              else sl.stop] for i, sl in enumerate(m[d])]
                            for d in mesh.devices.ravel()]
            out[f"{arch}|{mname}"] = rec
    json.dump(out, open(sys.argv[2], "w"))
''')


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The module's single-rank runs are steps of reduced models, whose
    small operations torch's thread pool only slows down (4-6 s for three
    steps on 8 threads, 0.2 s on one, on the CPU this was written on)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _popen(args, log: Path):
    """A child process on the host, its output in ``log``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    with open(log, "w") as f:
        return subprocess.Popen(args, env=env, stdout=f,
                                stderr=subprocess.STDOUT)


def _single_run(cfg, microbatches: int, batches, tc=None):
    """The port's single-rank ``make_train_step`` on the file's seeded
    weights and its case's settings (or ``tc``), in the file's layout:
    the metrics, the shards of the final state and of the first moment
    after the first step by mesh position; and the final state."""
    api = get_model(cfg)
    params = params_from_numpy(init_params_numpy(api.specs(),
                                                 SE.PARAM_SEED))
    opt = adamw_init(params)
    step = make_train_step(api, tc or S.case_train(cfg.name, microbatches,
                                                   TrainConfig))
    rows, first = dict(loss=[], grad_norm=[], lr=[]), None
    for b in batches:
        params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
        for k in rows:
            rows[k].append(float(m[k]))
        if first is None:
            first = {k: v.numpy() for k, v in ckpt._flatten(
                {"opt": opt}).items() if k.startswith(SE.FIRST_PREFIX)}
    state = {"params": params, "opt": opt}
    full = {k: v.numpy() for k, v in ckpt._flatten(state).items()
            if k != "opt/.step"}
    return dict(rows, shards=SE.by_position(full, cfg),
                first_mu=SE.by_position(first, cfg)), state


def _batches(cfg):
    return S.case_batches(cfg, SyntheticLMData)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every child process of the module: the reference's blocks and its
    first case live beside the 8-rank fixture case, then the launcher
    resuming a single-rank checkpoint on 8 ranks."""
    out = tmp_path_factory.mktemp("sharded")
    cfg = ARCHS["qwen3-0.6b"].reduced()
    one = launch.run(cfg, steps=S.RESUME_STEPS, global_batch=S.RESUME_BATCH,
                     seq=S.RESUME_SEQ, ckpt_dir=str(out / "one"),
                     save_every=0, keep=1, device="cpu", emit=lambda m: None,
                     stop_after=S.RESUME_AT)
    assert one["step"] == list(range(S.RESUME_AT))
    procs = {
        "blocks": _popen([sys.executable, "-c", _JAX,
                          json.dumps([FAMILIES, MESHES]),
                          str(out / "blocks.json")], out / "blocks.log"),
        "live": _popen([sys.executable, str(ROOT / "tools" /
                                            "shard_expected.py"),
                        "--case", "0"], out / "live.log")}
    try:
        # the two worlds of 8 ranks one after the other: ranks that wait
        # in a collective for a rank without a core slow each other down
        rcs = S.launch("fixture", str(out / "ranks"), device="cpu",
                       timeout=300, checks=True)
        procs["launcher"] = _popen([
            sys.executable, "-m", "repro_torch.launch.train", "--ranks", "8",
            "--model-parallel", "4", "--reduced", "--device", "cpu",
            "--steps", str(S.RESUME_STEPS), "--global-batch",
            str(S.RESUME_BATCH), "--seq", str(S.RESUME_SEQ),
            "--save-every", "0", "--ckpt-dir", str(out / "one")],
            out / "launcher.log")
        for p in procs.values():
            p.wait(timeout=300)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = {k: (out / f"{k}.log").read_text() for k in procs}
    assert rcs == [0] * 8, rcs
    for k, p in procs.items():
        assert p.returncode == 0, f"{k}:\n{logs[k][-4000:]}"
    ranks = [json.loads((out / "ranks" / f"fixture_rank{r}.json")
                        .read_text()) for r in range(8)]
    return dict(out=out, ranks=ranks, logs=logs,
                blocks=json.loads((out / "blocks.json").read_text()),
                live=json.loads(logs["live"].strip().splitlines()[-1]))


def _gathered(ranks, name) -> dict:
    """One run of the ranks in the file's layout."""
    r0 = ranks[0]["runs"][name]
    pos = [f"d{r['coords']['data']}m{r['coords']['model']}" for r in ranks]
    return dict(loss=r0["loss"], grad_norm=r0["grad_norm"], lr=r0["lr"],
                **{k: {p: r["runs"][name][k] for p, r in zip(pos, ranks)}
                   for k in ("shards", "first_mu")})


# -------------------------------------------------------- named_sharding

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_named_sharding_blocks_are_the_references(runs, arch, mesh_name):
    mesh = Mesh(MESHES[mesh_name])
    api = get_model(ARCHS[arch])
    rules = dict(DEFAULT_RULES, **api.rules_override())
    specs = api.specs()
    flat_specs = flatten_specs(param_partition_specs(specs, mesh, rules))
    want = runs["blocks"][f"{arch}|{mesh_name}"]
    assert sorted(flat_specs) == sorted(want)
    for key, spec in flat_specs.items():
        shape = ckpt._flatten(specs)[key].shape
        got = named_sharding(mesh, spec).devices_indices_map(shape)
        assert [[[s.start, s.stop] for s in got[r]]
                for r in range(mesh.size)] == want[key], (key, spec)


def test_named_sharding_cuts_blocks():
    mesh = Mesh({"data": 2, "model": 4})
    x = torch.arange(8 * 12).reshape(8, 12)
    ns = named_sharding(mesh, ("model", "data"))
    blk = ns.block(x, mesh.coords_of(6))            # data 1, model 2
    assert torch.equal(blk, x[4:6, 6:12])
    both = named_sharding(mesh, (("data", "model"),))
    assert torch.equal(both.block(x, mesh.coords_of(5)), x[5:6])
    with pytest.raises(ValueError, match="does not split"):
        named_sharding(mesh, ("model",)).index((6, 2), mesh.coords_of(0))


# ----------------------------------------------------------- the fixture

def test_ranks_agree_on_the_metrics(runs):
    ranks = runs["ranks"]
    assert [tuple(r["coords"].values()) for r in ranks] == \
        [(d, m) for d in range(2) for m in range(4)]
    for name in CASE_NAMES + ["mask"]:
        for r in ranks[1:]:
            for k in ("loss", "grad_norm", "lr"):
                assert r["runs"][name][k] == ranks[0]["runs"][name][k]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_fixture_case_equals_the_reference(runs, name):
    arch = name.split(":")[0]
    err = SE.compare(_gathered(runs["ranks"], name),
                     EXPECTED["cases"][name])
    assert not SE.over_tolerance(arch, err), err
    assert runs["ranks"][0]["runs"][name]["path"] == "tp"


@pytest.mark.parametrize("name", [n for n in CASE_NAMES
                                  if not n.startswith("granite")])
def test_fixture_case_equals_one_rank(runs, name):
    arch, size, mb = SE.CASES[CASE_NAMES.index(name)]
    cfg = S.case_config(arch, size, ARCHS)
    one, _ = _single_run(cfg, mb, _batches(cfg))
    err = SE.compare(_gathered(runs["ranks"], name), one)
    assert not SE.over_tolerance(arch, err), err


def test_moe_mesh_run_is_not_the_single_device_run(runs):
    """The reference's MoE on the mesh balances its experts per block of
    tokens, so its loss differs from one device's; the ranks follow the
    mesh (above), and differ from one rank as the reference does."""
    name = CASE_NAMES[3]
    cfg = S.case_config(*SE.CASES[3][:2], ARCHS)
    one, _ = _single_run(cfg, 1, _batches(cfg)[:1])
    ranks = runs["ranks"][0]["runs"][name]
    ref = EXPECTED["cases"][name]
    assert abs(ranks["loss"][0] - ref["loss"][0]) < 1e-5 * ref["loss"][0]
    assert abs(one["loss"][0] - ref["loss"][0]) > 1e-5 * ref["loss"][0]


def test_uneven_mask_takes_the_global_token_mean(runs):
    cfg = ARCHS["qwen3-0.6b"].reduced()
    one, state = _single_run(cfg, 1, [S.masked_batch(cfg)])
    err = SE.compare(_gathered(runs["ranks"], "mask"), one)
    assert not SE.over_tolerance("qwen3-0.6b", err), err
    # a mean of the ranks' own means is not this loss
    b = S.masked_batch(cfg)
    m = b["mask"].reshape(2, -1)
    assert m.sum(1)[0] != m.sum(1)[1]
    # rank 0's assembled state (``assemble_tree``) is the one rank's
    full = np.load(runs["out"] / "ranks" / "mask.npz")
    want = ckpt._flatten(state)
    assert sorted(full.files) == sorted(want)
    for k, v in want.items():       # each leaf against its magnitude
        v = v.numpy()
        assert np.abs(full[k] - v).max() <= SE.TOL * np.abs(v).max(), k


#: the moments after one ``cast_params_bf16`` step: their gradient is the
#: gradient of a bf16 copy, which one rank rounds once to bf16 (unit
#: roundoff 2^-8 of the element) and the ranks round once per data rank's
#: partial sum (2^-8 of each partial, which may cancel); 8 units of the
#: leaf's largest value (measured on the CPU: 1.23e-2)
BF16_MOMENT_TOL = 2.0 ** -5


def test_cast_params_bf16_equals_one_rank(runs):
    """Each shard is cast to bf16 before its gather; the step equals the
    single-rank step's bf16 compute copy: the loss and learning rate
    within 1e-5, the gradient norm and the parameters within ``TOL``, the
    moments within ``BF16_MOMENT_TOL``."""
    cfg = ARCHS["qwen3-0.6b"].reduced()
    one, _ = _single_run(cfg, 1, _batches(cfg)[:1], TrainConfig(
        cast_params_bf16=True, **S.TRAIN))
    err = SE.compare(_gathered(runs["ranks"], "cast_bf16"), one)
    assert max(err["loss"], err["lr"]) <= SE.LOSS_TOL, err
    assert max(err["grad_norm"], err["params_sumsq"],
               err["params_vals"]) <= SE.TOL, err
    assert max(err["moments_sumsq"], err["moments_vals"],
               err["first_moments_sumsq"], err["first_moments_vals"]) <= \
        BF16_MOMENT_TOL, err


def test_dropping_the_model_sum_is_caught(runs):
    err = SE.compare(_gathered(runs["ranks"], "drop_model_sum"),
                     EXPECTED["cases"][CASE_NAMES[0]])
    bad = SE.over_tolerance("qwen3-0.6b", err)
    assert bad and any(k.startswith(("grad_norm", "params", "moments"))
                       for k in bad), err


def test_dropping_the_gated_norm_sum_is_caught(runs):
    """zamba2's gated norm over the rank's own ``d_in`` columns only (its
    sum of squares not summed over ``model``) is caught at the first
    step, where the case itself holds to ``LOSS_TOL`` and ``TOL``."""
    name = next(n for n in CASE_NAMES if n.startswith(S.NORM_CASE))
    want = EXPECTED["cases"][name]
    got = _gathered(runs["ranks"], "drop_norm_sum")
    err = {}
    SE._shard_errs(got["first_mu"], want["first_mu"], err)
    loss = abs(got["loss"][0] - want["loss"][0]) / want["loss"][0]
    assert loss > SE.LOSS_TOL and err["moments_vals"] > SE.TOL, (loss, err)


def test_generic_path_equals_one_rank(runs):
    """A dense model whose heads do not split over ``model`` takes the
    generic path on the ranks, and its step equals one rank's."""
    cfg = S.generic_config(ARCHS)
    one, _ = _single_run(cfg, 1, _batches(cfg)[:1], TrainConfig(**S.TRAIN))
    got = _gathered(runs["ranks"], "generic")
    assert runs["ranks"][0]["runs"]["generic"]["path"] == "generic"
    err = SE.compare(got, one)
    assert not SE.over_tolerance(cfg.name, err), err


def test_first_grads_leaf_norms_equal_one_process(runs):
    """``launch.sharded.first_grads`` on the ranks (the sharded step's
    gradient of step 1, which ``chip_smoke.py`` phase "shard" holds leaf
    by leaf at full width) equals one process's: the loss within
    ``LOSS_TOL`` and the norm of every leaf within ``TOL``, on every
    rank."""
    one = S.first_grads(S.case_config(S.GRADS_CASE, "reduced", ARCHS),
                        "cpu")
    got = runs["ranks"][0]["runs"]["first_grads"]
    assert all(r["runs"]["first_grads"] == got for r in runs["ranks"])
    assert abs(got["loss"] - one["loss"]) <= SE.LOSS_TOL * abs(one["loss"])
    assert got["grad_norms"].keys() == one["grad_norms"].keys()
    bad = {k: (got["grad_norms"][k], v) for k, v in one["grad_norms"].items()
           if not abs(got["grad_norms"][k] - v) <= SE.TOL * v}
    assert not bad, bad


#: the subtrees of stacked layers, each gathered in its rematerialised
#: block: in the forward and again in the backward's recompute
_STACKED = ("blocks", "groups", "tail", "enc_blocks", "dec_blocks")


@pytest.mark.parametrize("name", CASE_NAMES)
def test_tp_gathers_only_data_blocks(runs, name):
    """On the TP path no rank gathers a leaf over ``model``: per step and
    rank the FSDP gathers (``gather_params:<axes>``) run over ``data``
    alone and move, for each leaf sharded over ``data``, the rank's block
    of it (its ``model`` shard's ``data`` block), once per use: twice for
    a layer's leaf (its block's forward and its recompute), once for the
    others, per microbatch."""
    arch, size, mb = SE.CASES[CASE_NAMES.index(name)]
    cfg = S.case_config(arch, size, ARCHS)
    api = get_model(cfg)
    mesh = Mesh({"data": S.MESH[0], "model": S.MESH[1]})
    specs = flatten_specs(shardings_for_train(api, mesh)[0])
    shapes = {k: s.shape for k, s in ckpt._flatten(api.specs()).items()}
    want = 0
    for key, spec in specs.items():
        axes = [a for ax in spec_axes(spec, len(shapes[key])) for a in ax]
        if "data" in axes:
            uses = 2 if key.split("/")[0] in _STACKED else 1
            want += uses * 4 * int(np.prod(shapes[key])) // int(
                np.prod([mesh.shape[a] for a in axes]))
    for r in runs["ranks"]:
        counts = r["runs"][name]["collectives"]
        gathers = sorted(k for k in counts if k.startswith("gather_params"))
        assert gathers == ["gather_params:data"], gathers
        assert counts["gather_params:data"][1] == want * mb * S.STEPS


def test_live_reference_case_equals_the_fixture(runs):
    err = SE.compare(runs["live"], EXPECTED["cases"][CASE_NAMES[0]])
    assert max(err.values()) < 1e-6, err


# --------------------------------------------------------- checkpoints

def _uninterrupted(tmp_path):
    cfg = ARCHS["qwen3-0.6b"].reduced()
    return launch.run(cfg, steps=S.RESUME_STEPS,
                      global_batch=S.RESUME_BATCH, seq=S.RESUME_SEQ,
                      ckpt_dir=str(tmp_path / "whole"), save_every=0,
                      keep=1, device="cpu", emit=lambda m: None)


def _close(a: dict, b: dict, tol: float = 1e-5):
    for k, v in b.items():
        np.testing.assert_allclose(a[k].numpy(), v.numpy(), rtol=tol,
                                   atol=tol, err_msg=k)


def test_ranks_checkpoint_resumes_on_one_rank(runs, tmp_path):
    """The ranks stopped after step 2 and wrote the full tree; one rank
    resumes it and ends where the uninterrupted run ends."""
    d = runs["out"] / "ranks" / "ckpt"
    assert ckpt.latest_step(str(d)) == S.RESUME_AT
    cfg = ARCHS["qwen3-0.6b"].reduced()
    res = launch.run(cfg, steps=S.RESUME_STEPS, global_batch=S.RESUME_BATCH,
                     seq=S.RESUME_SEQ, ckpt_dir=str(d), save_every=0,
                     keep=1, device="cpu", emit=lambda m: None)
    assert res["start_step"] == S.RESUME_AT and res["step"] == [2]
    whole = _uninterrupted(tmp_path)
    _close(ckpt._flatten(res["state"]), ckpt._flatten(whole["state"]))
    assert abs(res["loss"][0] - whole["loss"][2]) < 1e-5


def test_one_rank_checkpoint_resumes_on_the_ranks(runs, tmp_path):
    """The launcher's 8 ranks resumed the single-rank checkpoint of step 2
    and wrote step 3, equal to the uninterrupted run's state."""
    d = str(runs["out"] / "one")
    assert ckpt.latest_step(d) == S.RESUME_STEPS
    whole = _uninterrupted(tmp_path)
    tree, meta = ckpt.restore(whole["state"], d)
    assert meta["step"] == S.RESUME_STEPS
    _close(ckpt._flatten(tree), ckpt._flatten(whole["state"]))


# ------------------------------------------------------------ launcher

def test_launcher_on_ranks_runs_and_reports(runs):
    log = runs["logs"]["launcher"]
    assert re.search(r"arch=qwen3-0\.6b \([\d.]+M params\), mesh=\{'data': "
                     r"2, 'model': 4\}, device=cpu, ranks=8, path=tp", log)
    assert "step     2  loss" not in log        # reports every 10th step
    assert re.search(rf"done: {S.RESUME_STEPS} steps, \d+s, 0 restarts", log)


def test_launcher_one_rank_prints_as_before(tmp_path, capsys):
    launch.main(["--reduced", "--steps", "3", "--device", "cpu",
                 "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"arch=qwen3-0\.6b \([\d.]+M params\), mesh=\{'data'"
                        r": 1, 'model': 1\}, device=cpu", lines[0])
    assert re.fullmatch(r"step     0  loss \d+\.\d{4}  gnorm \d+\.\d{3}",
                        lines[1])
    assert re.fullmatch(r"done: 3 steps, \d+s, 0 restarts, 0 straggler "
                        r"steps flagged", lines[2]) and len(lines) == 3


# --------------------------------------------------------------- pieces

def test_jit_train_step_needs_a_rank_mesh():
    api = get_model(ARCHS["qwen3-0.6b"].reduced())
    with pytest.raises(TypeError, match="RankMesh"):
        jit_train_step(api, TrainConfig(), Mesh({"data": 2, "model": 4}))


def test_rank_rows_take_each_microbatch_block():
    mesh = Mesh({"data": 2, "model": 4})
    mesh.coords = mesh.coords_of(5)                 # data 1
    assert rank_rows(8, mesh) == [4, 5, 6, 7]
    assert rank_rows(8, mesh, 2) == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="does not split"):
        rank_rows(6, mesh, 2)


#: layouts whose heads do not divide the 4-way ``model`` axis
_UNSPLIT = {"qwen3-0.6b": dict(n_heads=S.GENERIC_HEADS),
            "rwkv6-7b": dict(d_model=48, n_heads=3)}


@pytest.mark.parametrize("arch", FAMILIES + tuple(
    f"{a}:unsplit" for a in _UNSPLIT))
def test_path_for_each_family(arch):
    """Every family takes tensor parallelism on (2, 4), at full size and
    reduced; a layout whose heads do not split over ``model`` the named
    generic path, never one rank's."""
    mesh = Mesh({"data": 2, "model": 4})
    name, _, unsplit = arch.partition(":")
    cfgs = [ARCHS[name], ARCHS[name].reduced()]
    if unsplit:
        cfgs = [dataclasses.replace(cfgs[1], **_UNSPLIT[name])]
    for cfg in cfgs:
        api = get_model(cfg)
        pspecs, _, _ = shardings_for_train(api, mesh)
        assert path_for(cfg, mesh, pspecs) == ("generic" if unsplit
                                               else "tp")
        assert tree_leaves(pspecs)
