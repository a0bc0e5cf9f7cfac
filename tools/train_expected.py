"""Write the reference package's training results on two small configs,
for the PyTorch port's train step to be held to, on the CPU and on the
card.

Two configs at their smoke-size reduction (``cfg.reduced()``: 2 layers,
d_model 64, vocabulary 256, float32): qwen3-0.6b (dense) and
granite-moe-1b-a400m (MoE, 4 experts, top-2, with the load-balancing term
in the loss).  Their weights are seeded numpy arrays from
``repro_torch.models.module.init_params_numpy`` (the port's specs, which
the CPU tests hold equal to the reference's), so both packages start from
the same weights.  Each config trains ``STEPS`` steps of the reference's
``make_train_step`` (jitted, as its launcher and tests run it) on
``SyntheticLMData(seed=0)`` batches of ``BATCH`` x ``SEQ`` tokens, with
``microbatches`` 1 and 2, under ``TRAIN``'s settings.  The file keeps,
per run, each step's loss, gradient norm and learning rate, and at the
end 8 evenly spaced values of every parameter leaf (flattened, by the
reference's checkpoint key), with the settings that rebuild the run.

``port_run`` replays one run through the port (``repro_torch``) on a
device, ``compare`` measures it against the file and ``over_tolerance``
holds it: every loss and learning rate, every run's first gradient norm
(both packages step from the same seeded state), every parameter slice
(relative to its largest magnitude) and the dense config's every gradient
norm within ``TOL`` relative; the MoE config's later gradient norms within
``DRIFT_TOL``.  Those drift apart: AdamW divides each gradient element by
its own root mean square plus 1e-8, so elements whose gradient is at
rounding level (|g| ~ 1e-8 in the expert weights, later in the embedding)
take steps of up to ``lr`` whose size and sign depend on rounding, and the
reference's own eager run differs from its jitted run by 2.2e-3 in the
gradient norm by step 8.  The CPU tests and ``chip_smoke.py`` use all
three.

The file also keeps one train step of every family (``STEP_ARCHS`` at
their reduction) from seeded numpy weights and a seeded batch
(``step_inputs``), with ``microbatches`` 1 and 4: the loss, gradient norm
and learning rate, and every parameter after the step, whole.  A
parameter ``p1`` is kept as its AdamW update ``u = (p0 - p1) / lr - wd *
p0`` (``p0`` the seeded weight, ``lr`` the step's learning rate, ``wd``
the weight decay), which lies in [-1, 1] on a first step, in steps of
1/127 (``UPDATE_SCALE``) as int8, zlib-compressed and base64-encoded
(``encode_update``); ``reference_params`` rebuilds ``p1``, within
``RECON_TOL`` of the reference's own values (checked when the file is
written).  With each step the file keeps, per leaf, the two packages'
gradient agreement (``grad_agree``: the largest difference of the port's
gradient from the reference's, both on the CPU) and the gradient band
(``band``): the flat indices of the elements whose reference gradient is
nonzero and within ``BAND_MARGIN`` times the two gradients' difference at
that element of zero, where they may differ in sign.  The CPU tests hold the port's step
to them.

Writes ``src/repro_torch/configs/train_expected.json``.

Usage: PYTHONPATH=src JAX_PLATFORMS=cpu python tools/train_expected.py
"""
from __future__ import annotations

import base64
import json
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "configs" / "train_expected.json"

ARCHS = ("qwen3-0.6b", "granite-moe-1b-a400m")
MICROBATCHES = (1, 2)
STEPS = 8
BATCH, SEQ = 4, 32
PARAM_SEED = 0
DATA_SEED = 0
TRAIN = dict(lr=3e-3, warmup_steps=2, total_steps=STEPS)
SLICE = 8
#: the port against the file, the largest relative difference allowed;
#: measured on the CPU (torch 2.13, float32): losses 5.1e-5, learning
#: rates 8.7e-7, first gradient norms 2.6e-6, the dense config's gradient
#: norms 2.0e-7, parameter slices 2.7e-7 (dense) and 6.3e-5 (MoE)
TOL = 1e-3
#: the MoE config's gradient norms after its first step: measured 1.4e-2
#: on the CPU (the drift above)
DRIFT_TOL = 5e-2
DRIFTS = ("granite-moe-1b-a400m",)


#: one train step of every family, ``microbatches`` 1 and 4
STEP_ARCHS = ("qwen3-0.6b", "granite-moe-1b-a400m", "internvl2-2b",
              "rwkv6-7b", "zamba2-7b", "seamless-m4t-large-v2")
STEP_MICROBATCHES = (1, 4)
STEP_BATCH, STEP_SEQ, STEP_FRAMES = 4, 12, 10
STEP_TRAIN = dict(lr=1e-3, warmup_steps=0)
#: a first step's update in [-1, 1] is kept as round(u * UPDATE_SCALE),
#: int8: ``reference_params`` then lies within lr / 254 of the reference
UPDATE_SCALE = 127
RECON_TOL = 5e-6
#: the gradient band: an element whose reference gradient is nonzero and
#: within ``BAND_MARGIN`` times the two packages' measured difference at
#: that element of zero may step either way
BAND_MARGIN = 2.0


def step_inputs(cfg) -> tuple:
    """(numpy weights, numpy batch) of one family's step: the weights from
    the port's specs with ``PARAM_SEED``, the tokens and labels in the
    reduced vocabulary, a vlm's patch embeddings and an encdec's
    ``STEP_FRAMES`` frames standard normal, all from one seeded draw."""
    from repro_torch.models import get_model
    from repro_torch.models.module import init_params_numpy
    params = init_params_numpy(get_model(cfg).specs(), PARAM_SEED)
    rng = np.random.default_rng(PARAM_SEED + 1)
    batch = {k: rng.integers(0, 256, (STEP_BATCH, STEP_SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = rng.standard_normal(
            (STEP_BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frame_embeds"] = rng.standard_normal(
            (STEP_BATCH, STEP_FRAMES, cfg.d_model)).astype(np.float32)
    return params, batch


def run_name(arch: str, microbatches: int) -> str:
    return f"{arch}:mb{microbatches}"


def param_slices(flat: dict) -> dict:
    """{key: SLICE evenly spaced values of the flattened leaf}."""
    out = {}
    for key, leaf in flat.items():
        a = np.asarray(leaf, np.float32).ravel()
        idx = np.linspace(0, a.size - 1, min(SLICE, a.size)).astype(int)
        out[key] = a[idx].tolist()
    return out


def _reference_run(arch: str, microbatches: int) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import TrainConfig
    from repro.data import SyntheticLMData
    from repro.models import get_model
    from repro.train import checkpoint as ckpt
    from repro.train.optimizer import adamw_init
    from repro.train.train_loop import make_train_step
    from repro_torch.configs import ARCHS
    from repro_torch.models import get_model as port_model
    from repro_torch.models.module import init_params_numpy

    cfg = REF_ARCHS[arch].reduced()
    api = get_model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, init_params_numpy(
        port_model(ARCHS[arch].reduced()).specs(), PARAM_SEED))
    opt = adamw_init(params)
    tc = TrainConfig(microbatches=microbatches, **TRAIN)
    step = jax.jit(make_train_step(api, tc))
    data = SyntheticLMData(vocab_size=cfg.padded_vocab(), seq_len=SEQ,
                           global_batch=BATCH, seed=DATA_SEED)
    rows = dict(loss=[], grad_norm=[], lr=[])
    for s in range(STEPS):
        b = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
        params, opt, m = step(params, opt, b)
        for k in rows:
            rows[k].append(float(m[k]))
    flat, _ = ckpt._flatten(params)
    return dict(rows, params=param_slices(flat))


def port_run(arch: str, microbatches: int, device="cpu") -> dict:
    """One run of the file through the port's ``make_train_step`` on
    ``device``, in the file's layout."""
    import torch
    from repro_torch.configs import ARCHS, TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import get_model
    from repro_torch.models.module import init_params_numpy, params_from_numpy
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_loop import make_train_step

    cfg = ARCHS[arch].reduced()
    api = get_model(cfg)
    params = params_from_numpy(init_params_numpy(api.specs(), PARAM_SEED),
                               device)
    opt = adamw_init(params)
    step = make_train_step(api, TrainConfig(microbatches=microbatches,
                                            **TRAIN))
    data = SyntheticLMData(vocab_size=cfg.padded_vocab(), seq_len=SEQ,
                           global_batch=BATCH, seed=DATA_SEED)
    rows = dict(loss=[], grad_norm=[], lr=[])
    for s in range(STEPS):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch(s).items()}
        params, opt, m = step(params, opt, b)
        for k in rows:
            rows[k].append(float(m[k]))
    return dict(rows, params=param_slices(
        {k: v.cpu() for k, v in ckpt._flatten(params).items()}))


def compare(got: dict, want: dict) -> dict:
    """The largest relative difference of each quantity of one run:
    ``loss``, ``grad_norm``, ``lr`` (each value against its own
    magnitude) and ``params`` (each slice against its largest
    magnitude)."""
    out = {}
    for k in ("loss", "grad_norm", "lr"):
        a, b = np.asarray(got[k]), np.asarray(want[k])
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
        out[k] = float(np.max(rel))
        if k == "grad_norm":
            out["grad_norm_first"] = float(rel[0])
    if sorted(got["params"]) != sorted(want["params"]):
        raise ValueError("the parameter trees differ")
    out["params"] = max(
        float(np.max(np.abs(np.subtract(got["params"][key], w))) /
              max(float(np.max(np.abs(w))), 1e-30))
        for key, w in want["params"].items())
    return out


def over_tolerance(arch: str, err: dict) -> list:
    """The quantities of ``compare``'s result beyond their tolerance, as
    ``"name value > tolerance"`` strings (empty when the run holds)."""
    tols = dict(loss=TOL, lr=TOL, grad_norm_first=TOL,
                grad_norm=DRIFT_TOL if arch in DRIFTS else TOL, params=TOL)
    return [f"{k} {err[k]:.3e} > {t:.0e}" for k, t in tols.items()
            if not err[k] <= t]


def encode_update(u: np.ndarray) -> str:
    """A first step's update (values in [-1, 1]) as base64 text of the
    zlib-compressed int8 ``round(u * UPDATE_SCALE)``."""
    q = np.rint(np.asarray(u, np.float64).ravel() * UPDATE_SCALE)
    if q.size and np.abs(q).max() > UPDATE_SCALE:
        raise ValueError(f"an update outside [-1, 1]: {np.abs(q).max()}")
    return base64.b64encode(zlib.compress(q.astype(np.int8).tobytes(),
                                          9)).decode("ascii")


def decode_update(text: str) -> np.ndarray:
    q = np.frombuffer(zlib.decompress(base64.b64decode(text)), np.int8)
    return q.astype(np.float32) / np.float32(UPDATE_SCALE)


def reference_params(arch: str, want: dict) -> dict:
    """{checkpoint key: the reference's flattened parameter after the
    file's step ``want``}, rebuilt from the seeded weights and the kept
    update in the reference's float32 order, ``p0 - lr * (u + wd * p0)``."""
    from repro_torch.configs import ARCHS
    from repro_torch.train import checkpoint as ckpt
    params, _ = step_inputs(ARCHS[arch].reduced())
    lr, wd = np.float32(want["lr"]), np.float32(want["weight_decay"])
    out = {}
    for key, p0 in ckpt._flatten(params).items():
        p0 = np.asarray(p0, np.float32).ravel()
        out[key] = p0 - lr * (decode_update(want["update"][key]) + wd * p0)
    return out


def _microbatch_grads(grad, params, batch: dict, microbatches: int,
                      flatten) -> dict:
    """{checkpoint key: the mean of ``grad`` over the batch's equal
    microbatches, as a flat float32 array}."""
    parts = [flatten(grad(params, {
        k: v.reshape(microbatches, v.shape[0] // microbatches,
                     *v.shape[1:])[i] for k, v in batch.items()}))
        for i in range(microbatches)]
    return {k: sum(np.asarray(p[k], np.float32).ravel() for p in parts) /
            np.float32(microbatches) for k in parts[0]}


def _port_grads(arch: str, microbatches: int) -> dict:
    """The port's gradient of ``step_inputs``'s step, as
    ``_microbatch_grads`` gives it, on the CPU."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import get_model
    from repro_torch.models.module import params_from_numpy, value_and_grad
    from repro_torch.train import checkpoint as ckpt
    cfg = ARCHS[arch].reduced()
    npp, batch = step_inputs(cfg)
    grad = value_and_grad(get_model(cfg).loss_fn)
    return _microbatch_grads(
        lambda p, b: grad(p, b)[1], params_from_numpy(npp),
        {k: torch.from_numpy(v) for k, v in batch.items()}, microbatches,
        lambda t: {k: v.numpy() for k, v in ckpt._flatten(t).items()})


def _reference_step(arch: str, microbatches: int) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import TrainConfig
    from repro.models import get_model
    from repro.train import checkpoint as ckpt
    from repro.train.optimizer import adamw_init
    from repro.train.train_loop import make_train_step
    from repro_torch.configs import ARCHS

    npp, batch = step_inputs(ARCHS[arch].reduced())
    params = jax.tree_util.tree_map(jnp.asarray, npp)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    api = get_model(REF_ARCHS[arch].reduced())
    tc = TrainConfig(microbatches=microbatches, **STEP_TRAIN)
    after, _, m = jax.jit(make_train_step(api, tc))(
        params, adamw_init(params), batch)
    # the step's gradient as its microbatches make it (their mean), in
    # both packages
    grads = _microbatch_grads(jax.jit(jax.grad(api.loss_fn)), params, batch,
                              microbatches, lambda t: ckpt._flatten(t)[0])
    port = _port_grads(arch, microbatches)
    p0s, _ = ckpt._flatten(params)
    p1s, _ = ckpt._flatten(after)
    lr, wd = np.float32(m["lr"]), np.float32(tc.weight_decay)
    update, agree, band = {}, {}, {}
    for key, p0 in p0s.items():
        p0 = np.asarray(p0, np.float32).ravel()
        update[key] = encode_update(
            (p0 - np.asarray(p1s[key], np.float32).ravel()) / lr - wd * p0)
        g = np.asarray(grads[key], np.float32).ravel()
        diff = np.abs(port[key] - g)
        agree[key] = float(np.max(diff, initial=0.0))
        band[key] = np.flatnonzero(
            (g != 0) & (np.abs(g) <= BAND_MARGIN * diff)).tolist()
    out = dict({k: float(m[k]) for k in ("loss", "grad_norm", "lr")},
               weight_decay=float(tc.weight_decay), update=update,
               grad_agree=agree, band=band)
    recon = reference_params(arch, out)
    err = max(float(np.max(np.abs(recon[k] - np.asarray(
        p1s[k], np.float32).ravel()), initial=0.0)) for k in p1s)
    if err > RECON_TOL:
        raise AssertionError(f"{arch}: the kept update rebuilds the "
                             f"parameters within {err:.2e} > {RECON_TOL}")
    return out


def main() -> None:
    import jax
    out = dict(
        config=dict(archs=list(ARCHS), microbatches=list(MICROBATCHES),
                    steps=STEPS, batch=BATCH, seq=SEQ, param_seed=PARAM_SEED,
                    data_seed=DATA_SEED, train=TRAIN, slice=SLICE,
                    jax=jax.__version__),
        runs={run_name(a, mb): _reference_run(a, mb)
              for a in ARCHS for mb in MICROBATCHES},
        step_config=dict(archs=list(STEP_ARCHS),
                         microbatches=list(STEP_MICROBATCHES),
                         batch=STEP_BATCH, seq=STEP_SEQ, frames=STEP_FRAMES,
                         train=STEP_TRAIN, update_scale=UPDATE_SCALE,
                         band_margin=BAND_MARGIN),
        steps={run_name(a, mb): _reference_step(a, mb)
               for a in STEP_ARCHS for mb in STEP_MICROBATCHES})
    OUT.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
