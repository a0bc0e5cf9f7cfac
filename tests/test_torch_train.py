"""The port's training substrate (``repro_torch.train``, ``data``,
``launch.train``) against the reference package on the CPU: every case of
``test_train.py`` through the port; the data pipeline's batches element
for element; the optimizer within 1e-6 of the reference's; one train step
of every family at reduced width from the same numpy weights and batch
(loss within 1e-5, gradient norm within 1e-4, every element of every
parameter within the reference's own microbatch tolerance, rtol 2e-3 /
atol 2e-4), and 4 microbatches against the reference's 4, from the JAX
package's steps in ``configs/train_expected.json`` (kept whole).  AdamW's
first step moves every parameter by about ``lr`` times the sign of its
gradient, so an element whose reference gradient is nonzero but within
the two packages' measured gradient agreement of zero (the file's
``band``: within twice the two gradients' difference at that element,
``tools/train_expected.py``) may step either way; those elements, at most
``BAND_PER_LEAF`` in a leaf, are held to one step's reach, 2 lr, and at
most ``BAND_USED`` of them may need it.  Elements with a zero gradient are
held like the others.  Then the 8-step runs of
``configs/train_expected.json`` (``tools/train_expected.py``), and runs
with one leaf's update skipped, which they must catch; the training route
of ``kernels.ops``; the launcher; and ``TrainConfig``, ``SHAPES`` and the
shape helpers equal to the reference's."""
import dataclasses
import inspect
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import base as ref_base
from repro.data import SyntheticLMData as RefData
from repro.train import optimizer as ref_opt
from repro_torch.configs import (ARCHS, FULL_ATTENTION_ONLY, SHAPES,
                                 TrainConfig, shape_applicable)
from repro_torch.data import DataState, SyntheticLMData
from repro_torch.kernels import ops
from repro_torch.launch import train as launch
from repro_torch.models import get_model
from repro_torch.models.module import params_from_numpy, tree_leaves
from repro_torch.train.optimizer import (adamw_init, adamw_update, cosine_lr,
                                         global_norm)
from repro_torch.train.train_loop import make_train_step

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import train_expected as TE  # noqa: E402


@pytest.fixture(autouse=True)
def _on_the_host(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")


def tiny_cfg():
    return ARCHS["qwen3-0.6b"].reduced()


def _batch(seed: int, B: int = 8, T: int = 16, V: int = 200) -> dict:
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, V, (B, T)).astype(np.int32))
            for k in ("tokens", "labels")}


# ------------------------------------------- the cases of test_train.py

def test_adamw_decreases_quadratic():
    tc = TrainConfig(lr=0.1, warmup_steps=0, total_steps=100,
                     weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params)
    for _ in range(60):
        g = torch.func.grad(lambda p: torch.sum(p["w"] ** 2))(params)
        params, opt, _ = adamw_update(params, g, opt, tc)
    assert float(params["w"].abs().max()) < 0.5


def test_cosine_schedule():
    tc = TrainConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    assert float(cosine_lr(tc, 0)) == 0.0
    assert float(cosine_lr(tc, 10)) == pytest.approx(1e-3, rel=1e-3)
    assert float(cosine_lr(tc, 100)) == pytest.approx(0.0, abs=1e-6)


def test_grad_clip_caps_norm():
    tc = TrainConfig(grad_clip=1.0, lr=1.0, warmup_steps=0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    opt = adamw_init(params)
    big = {"w": torch.full((4,), 100.0)}
    p2, _, m = adamw_update(params, big, opt, tc)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    assert float(p2["w"].abs().max()) < 2.0     # clipped step


def test_microbatch_equivalence():
    """grad accumulation over 4 microbatches == single big batch (mean CE
    over equal-sized microbatches averages exactly)."""
    api = get_model(tiny_cfg())
    params = api.init(torch.Generator().manual_seed(0))
    batch = _batch(1)
    opt = adamw_init(params)
    tc1 = TrainConfig(microbatches=1, lr=1e-3, warmup_steps=0)
    tc4 = TrainConfig(microbatches=4, lr=1e-3, warmup_steps=0)
    p1, _, m1 = make_train_step(api, tc1)(params, opt, batch)
    p4, _, m4 = make_train_step(api, tc4)(params, opt, batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-4)


def test_end_to_end_loss_decreases():
    """A few dozen steps on the synthetic motif data must cut the loss."""
    cfg = tiny_cfg()
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    opt = adamw_init(params)
    tc = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=60, z_loss=0.0)
    step = make_train_step(api, tc)
    data = SyntheticLMData(vocab_size=cfg.padded_vocab(), seq_len=32,
                           global_batch=8, seed=0)
    losses = []
    for i in range(40):
        b = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, \
        losses[:3] + losses[-3:]


def test_data_pipeline_deterministic_and_sharded():
    d1 = SyntheticLMData(1000, 64, 8, seed=7)
    d2 = SyntheticLMData(1000, 64, 8, seed=7)
    b1, b2 = d1.batch(3), d2.batch(3)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(d1.batch(3)["tokens"], d1.batch(4)["tokens"])
    # labels are next-token shifted
    assert np.array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    # host sharding: two hosts cover the global batch deterministically
    h0 = SyntheticLMData(1000, 64, 8, seed=7, process_index=0,
                         process_count=2)
    h1 = SyntheticLMData(1000, 64, 8, seed=7, process_index=1,
                         process_count=2)
    assert h0.batch(0)["tokens"].shape[0] == 4
    assert not np.array_equal(h0.batch(0)["tokens"], h1.batch(0)["tokens"])


# ------------------------------------------------ data and configs

@pytest.mark.parametrize("seed,step,pidx,pcount", [
    (0, 0, 0, 1), (7, 3, 0, 1), (7, 3, 1, 2), (123, 41, 3, 4)])
def test_batches_equal_reference(seed, step, pidx, pcount):
    kw = dict(vocab_size=1000, seq_len=64, global_batch=8, seed=seed,
              process_index=pidx, process_count=pcount)
    got, want = SyntheticLMData(**kw), RefData(**kw)
    b, r = got.batch(step), want.batch(step)
    assert sorted(b) == sorted(r)
    for k in b:
        assert b[k].dtype == r[k].dtype and np.array_equal(b[k], r[k])
    it, rit = iter(got), iter(want)
    for _ in range(2):
        assert np.array_equal(next(it)["tokens"], next(rit)["tokens"])
    assert DataState.from_dict(DataState(5).as_dict()).step == 5


def test_configs_equal_reference():
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(RefTrainConfig())
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}
    assert FULL_ATTENTION_ONLY == ref_base.FULL_ATTENTION_ONLY
    for name in ARCHS:
        for shape in SHAPES.values():
            assert shape_applicable(name, shape) == ref_base.shape_applicable(
                name, ref_base.SHAPES[shape.name])
        assert ARCHS[name].active_params_per_token_factor() == \
            REF_ARCHS[name].active_params_per_token_factor()


# ------------------------------------------------------- the optimizer

def _tree_pair(seed: int):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"x": rng.standard_normal(7).astype(np.float32)}}
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree))


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def _path_tree(tree, prefix=()):
    """The tree with every leaf replaced by its path."""
    if isinstance(tree, dict):
        return {k: _path_tree(v, prefix + (k,)) for k, v in tree.items()}
    return "/".join(prefix)


@pytest.mark.parametrize("name", sorted({c.name for c in ARCHS.values()}))
def test_global_norm_sums_in_the_references_leaf_order(name):
    """ROADMAP C 20: ``global_norm`` adds the leaves in
    ``jax.tree_util.tree_leaves``'s order (dict keys sorted at every
    level), and on every family's reduced tree the two packages' norms
    agree within 1e-6, relative."""
    from repro_torch.models.module import init_params_numpy, tree_leaves_sorted
    api = get_model(ARCHS[name].reduced())
    paths = _path_tree(api.specs())
    assert tree_leaves_sorted(paths) == jax.tree_util.tree_leaves(paths)
    assert tree_leaves_sorted(paths) != tree_leaves(paths)
    g = init_params_numpy(api.specs(), seed=3)
    got = float(global_norm(params_from_numpy(g)))
    want = float(ref_opt.global_norm(jax.tree_util.tree_map(jnp.asarray, g)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
def test_optimizer_matches_reference(grad_clip):
    """From the same params, gradients and moments, three updates of
    ``adamw_update`` (clip scale, bias corrections, weight decay on the
    float32 master) within 1e-6 of the reference's; ``cosine_lr`` and
    ``global_norm`` too."""
    tc = TrainConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                     grad_clip=grad_clip)
    rtc = RefTrainConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                         grad_clip=grad_clip)
    rp, p = _tree_pair(0)
    ropt, opt = ref_opt.adamw_init(rp), adamw_init(p)
    assert opt.step.dtype == torch.int32 and opt.step.ndim == 0
    for i in range(3):
        rg, g = _tree_pair(10 + i)
        assert float(global_norm(g)) == pytest.approx(
            float(ref_opt.global_norm(rg)), rel=1e-6)
        rp, ropt, rm = ref_opt.adamw_update(rp, rg, ropt, rtc)
        p, opt, m = adamw_update(p, g, opt, tc)
        for k in ("grad_norm", "lr"):
            _close(m[k], rm[k])
        _close(p["w"], rp["w"])
        _close(p["b"]["x"], rp["b"]["x"])
        _close(opt.mu["w"], ropt.mu["w"])
        _close(opt.nu["b"]["x"], ropt.nu["b"]["x"])
        assert int(opt.step) == int(ropt.step)
    for s in range(0, 12):
        _close(cosine_lr(tc, s), ref_opt.cosine_lr(rtc, s))
        _close(cosine_lr(tc, torch.tensor(s, dtype=torch.int32)),
               ref_opt.cosine_lr(rtc, jnp.int32(s)))


# -------------------------------------------- the train step, every family

#: the band may hold at most this many elements of a leaf (measured on
#: the CPU: 3 at most, in seamless's blocks; 23 in all of seamless's step,
#: at most one in the other families')
BAND_PER_LEAF = 4
#: ... and at most this many of a step's elements may need its reach
#: (measured: one, in seamless's encoder)
BAND_USED = 2


def _port_step(arch: str, microbatches: int):
    """The port's step from ``TE.step_inputs``: (metrics, {checkpoint key:
    the flattened parameter after the step})."""
    from repro_torch.train import checkpoint as ckpt
    cfg = ARCHS[arch].reduced()
    api = get_model(cfg)
    npp, nb = TE.step_inputs(cfg)
    p, b = params_from_numpy(npp), {k: torch.from_numpy(v)
                                    for k, v in nb.items()}
    tc = TrainConfig(microbatches=microbatches, **TE.STEP_TRAIN)
    p2, opt2, m = make_train_step(api, tc)(p, adamw_init(p), b)
    assert int(opt2.step) == 1
    return ({k: float(v) for k, v in m.items()},
            {k: v.reshape(-1).numpy() for k, v in ckpt._flatten(p2).items()})


def _hold_params(got: dict, want: dict, band: dict, lr: float) -> int:
    """Every element within the reference's microbatch tolerance, except
    those of the gradient band, which are held to one step's reach, 2 lr;
    the band may hold at most ``BAND_PER_LEAF`` elements of a leaf.
    Returns how many band elements needed the reach."""
    assert sorted(got) == sorted(want) == sorted(band)
    used = 0
    for key, p in got.items():
        w, idx = want[key], np.asarray(band[key], dtype=np.int64)
        assert len(idx) <= BAND_PER_LEAF, (key, len(idx))
        sure = np.ones(w.size, bool)
        sure[idx] = False
        np.testing.assert_allclose(p[sure], w[sure], rtol=2e-3, atol=2e-4,
                                   err_msg=key)
        off = np.abs(p[idx] - w[idx])
        assert np.all(off <= 2 * lr + 2e-4), key
        used += int(np.sum(off > 2e-4 + 2e-3 * np.abs(w[idx])))
    return used


@pytest.mark.parametrize("microbatches", TE.STEP_MICROBATCHES)
@pytest.mark.parametrize("name", TE.STEP_ARCHS)
def test_train_step_matches_reference(name, microbatches):
    """One step of every family, with 1 and 4 microbatches, from the same
    numpy weights and batch as the JAX package's step in
    ``train_expected.json``: loss within 1e-5, gradient norm within 1e-4,
    the learning rate, and every element of every parameter."""
    want = json.loads(TE.OUT.read_text())["steps"][TE.run_name(
        name, microbatches)]
    m, got = _port_step(name, microbatches)
    assert m["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert m["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
    assert m["lr"] == pytest.approx(want["lr"], rel=1e-6)
    used = _hold_params(got, TE.reference_params(name, want), want["band"],
                        TE.STEP_TRAIN["lr"])
    assert used <= BAND_USED


def test_uneven_microbatches_raise():
    api = get_model(tiny_cfg())
    params = api.init(torch.Generator().manual_seed(0))
    step = make_train_step(api, TrainConfig(microbatches=3))
    with pytest.raises(ValueError, match="microbatches"):
        step(params, adamw_init(params), _batch(0, B=8))


def test_cast_params_bf16_reaches_the_float32_masters():
    """With ``cast_params_bf16`` the forward runs on bf16 copies of the
    matrices; the update lands on the float32 masters, close to the
    float32 step."""
    api = get_model(tiny_cfg())
    params = api.init(torch.Generator().manual_seed(0))
    batch = _batch(2)
    out = {}
    for cast in (False, True):
        tc = TrainConfig(lr=1e-3, warmup_steps=0, cast_params_bf16=cast)
        p2, _, m = make_train_step(api, tc)(params, adamw_init(params), batch)
        out[cast] = (p2, float(m["loss"]))
    for leaf in tree_leaves(out[True][0]):
        assert leaf.dtype == torch.float32
    assert out[True][1] == pytest.approx(out[False][1], rel=2e-2)
    assert out[True][1] != out[False][1]


@pytest.mark.parametrize("index", range(4))
def test_train_fixture_on_the_host(index):
    """The port's CPU path reproduces ``train_expected.json`` (the JAX
    package's 8-step runs) within the fixture's tolerances."""
    want = json.loads(TE.OUT.read_text())
    arch, mb = [(a, m) for a in TE.ARCHS for m in TE.MICROBATCHES][index]
    err = TE.compare(TE.port_run(arch, mb), want["runs"][TE.run_name(
        arch, mb)])
    assert not TE.over_tolerance(arch, err), err


@pytest.mark.parametrize("leaf", ["router", "wg", "ln2"])
def test_train_fixture_catches_a_skipped_update(leaf, monkeypatch):
    """A granite-moe run whose router, expert or norm weights are never
    updated reads as over tolerance: every run's parameter slices are
    held within ``TOL``."""
    from repro_torch.train import train_loop
    real = train_loop.adamw_update

    def skip(params, grads, opt, tc):
        new, opt, m = real(params, grads, opt, tc)
        new["blocks"][leaf] = params["blocks"][leaf]
        return new, opt, m
    monkeypatch.setattr(train_loop, "adamw_update", skip)
    arch = "granite-moe-1b-a400m"
    want = json.loads(TE.OUT.read_text())["runs"][TE.run_name(arch, 1)]
    bad = TE.over_tolerance(arch, TE.compare(TE.port_run(arch, 1), want))
    assert any(b.startswith("params ") for b in bad), bad


# ------------------------------------------------------ the training route

def test_training_route_is_entered_only_by_the_train_step():
    """``ops.differentiable()`` nests and restores; ``make_train_step``
    runs the loss inside it, and nothing else is inside it."""
    assert not ops.training_route()
    with ops.differentiable():
        assert ops.training_route()
        with ops.differentiable():
            assert ops.training_route()
        assert ops.training_route()
    assert not ops.training_route()
    api = get_model(tiny_cfg())
    seen = []
    real = api.loss_fn

    def spy(p, b):
        seen.append(ops.training_route())
        return real(p, b)
    api.loss_fn = spy
    params = api.init(torch.Generator().manual_seed(0))
    make_train_step(api, TrainConfig())(params, adamw_init(params),
                                        _batch(3))
    assert seen == [True] and not ops.training_route()


def test_training_route_dispatch_rule(monkeypatch):
    """The dispatch rule: CPU and meta tensors take the plain version
    everywhere; inside the training route every device does.  (CUDA
    tensors outside it take the kernel or raise: ``test_torch_gpu.py``.)"""
    x = torch.zeros(2, requires_grad=True)
    m = torch.empty(2, device="meta")
    assert ops._plain(x) and ops._plain(m)
    with ops.differentiable():
        assert ops._plain(x) and ops._plain(m)
    with pytest.raises(ValueError, match="meta"):
        ops._plain(x, m)
    with ops.differentiable(), pytest.raises(ValueError, match="meta"):
        ops._plain(x, m)


# ------------------------------------------------------------ the launcher

def test_launcher_default_arch_is_the_references():
    """``python -m repro_torch.launch.train`` with no ``--arch`` trains
    what ``python -m repro.launch.train`` trains, with its defaults."""
    from repro.launch import train as ref_launch
    src = inspect.getsource(ref_launch.main)
    ref_default = src.split('"--arch", default="', 1)[1].split('"', 1)[0]
    assert ref_default == "qwen3-0.6b"
    args = launch.parser().parse_args([])
    assert args.arch == ref_default
    assert (args.steps, args.global_batch, args.seq, args.microbatches,
            args.save_every, args.reduced, args.device) == \
        (50, 8, 128, 1, 25, False, None)
    assert launch.parser().parse_args(["--no-reduced"]).reduced is False


def test_launcher_runs_reduced_on_the_host(tmp_path, capsys):
    launch.main(["--reduced", "--steps", "3", "--device", "cpu",
                 "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "arch=qwen3-0.6b" in out and "done: 3 steps" in out
    assert "0 restarts" in out
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["step_00000000", "step_00000003"]


def test_launcher_run_reports_and_resumes(tmp_path):
    seen = set()

    def fail_once(s):
        if s == 3 and s not in seen:
            seen.add(s)
            return True
        return False
    res = launch.run(tiny_cfg(), steps=4, global_batch=4, seq=16,
                     ckpt_dir=str(tmp_path), save_every=2, device="cpu",
                     inject_failure=fail_once, emit=lambda m: None)
    assert res["restarts"] == 1 and res["step"] == [0, 1, 2, 2, 3]
    assert np.isfinite(res["loss"]).all() and res["device"] == "cpu"
    again = launch.run(tiny_cfg(), steps=6, global_batch=4, seq=16,
                       ckpt_dir=str(tmp_path), save_every=2, device="cpu",
                       emit=lambda m: None)
    assert again["start_step"] == 4 and again["step"] == [4, 5]


@pytest.mark.parametrize("flag", ["--production-mesh", "--multi-pod"])
def test_launcher_refuses_the_production_meshes(flag):
    with pytest.raises(SystemExit, match="dry-run"):
        launch.main([flag, "--reduced", "--device", "cpu"])
