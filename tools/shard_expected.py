"""Write the reference package's sharded training results, for the PyTorch
port's sharded train step (``repro_torch.train.train_loop.jit_train_step``
over ``torch.distributed`` ranks) to be held to, on the CPU and on the
card.

The reference's ``jit_train_step`` runs on 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``) on a (2, 4)
(data, model) mesh, float32, for ``STEPS`` steps of ``TRAIN``'s settings
on ``SyntheticLMData(seed=0)`` batches of ``BATCH`` x ``SEQ`` tokens
(``case_batches``: a vlm's carry seeded ``prefix_embeds``, an encdec's
seeded ``frame_embeds``, the same numpy arrays the port's ranks get).
Its weights are seeded numpy arrays from
``repro_torch.models.module.init_params_numpy`` (the port's specs, which
the CPU tests hold equal to the reference's), so both packages start from
the same weights.  ``CASES``:

* reduced qwen3-0.6b, whose 2 KV heads are replicated on the 4-way
  ``model`` axis, with ``microbatches`` 1 and 2;
* ``tests/test_dryrun_small.py``'s qwen3 (3 layers, d 128, 8 heads, 4 KV
  heads that divide the axis, vocabulary 512), here in float32;
* reduced granite-moe-1b-a400m (the MoE layer's "tp" ``shard_map``);
* reduced rwkv6-7b, without the gradient clip (``CASE_TRAIN``: its seeded
  bonus ``u`` has a gradient of norm 5.8e5, whose clip would put every
  other element's step in AdamW's ``eps`` regime, where two roundings of
  the same step differ by 4e-2 of a parameter leaf on the card);
* reduced internvl2-2b with its 8 patch positions, zamba2-7b (one group
  of 2 Mamba2 blocks after the shared attention; without the clip, as
  ``CASE_TRAIN`` says) and seamless-m4t-large-v2 over 32 frames.

The file keeps, per case, each step's loss, gradient norm and learning
rate, and for each mesh position ``d<i>m<j>`` (the device at
``mesh.devices[i, j]``, the port's rank ``4 i + j``) its shard of every
parameter and AdamW moment after the last step (``shards``) and of the
first moment after the first step (``first_mu``: the clipped gradient),
by checkpoint key (``params/...``, ``opt/.mu/...``, ``opt/.nu/...``): the
shard's shape, its float64 sum of squares and ``SLICE`` evenly spaced
values of it, flattened.

``summary`` makes that record of a shard; ``compare`` measures the port's
against the file and ``over_tolerance`` holds it: the first step's loss
within ``LOSS_TOL`` relative and its gradient norm and first moments
within ``tools/train_expected.py``'s ``TOL``; every loss and learning rate
within ``LOSS_TOL``, the gradient norms and the final shards within
``TOL``, but where ``DRIFT_BOUNDS`` widens them, each from the
reference's own drift (``--drift``; ROADMAP §C 19).

Writes ``src/repro_torch/configs/shard_expected.json``.  ``--case N``
prints case N's record as JSON instead (the CPU tests' live check);
``--drift N`` prints case N's runs on ``DRIFT_MESHES`` (one device and
the other shapes of 8) compared with the file's, the reference's own
drift.

Usage: PYTHONPATH=src JAX_PLATFORMS=cpu python tools/shard_expected.py
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "configs" / "shard_expected.json"
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(ROOT / "src"))

import train_expected as TE  # noqa: E402

# the cases, their settings and the shard records are the port's rank
# runner's, so that both sides run the same thing
from repro_torch.launch.sharded import (  # noqa: E402
    BATCH, CASE_TRAIN, CASES, DATA_SEED, MESH, PARAM_SEED, SEQ, SLICE,
    STEPS, TRAIN, case_batches, case_config, case_name, case_train, summary)

TOL, DRIFT_TOL = TE.TOL, TE.DRIFT_TOL
LOSS_TOL = 1e-5
#: the AdamW moments after the last step of the cases whose float32
#: gradients drift (ROADMAP §C 19): the port's against the file measured
#: 4.1e-3 (granite-moe, its routing) and 3.3e-3 (rwkv6) on the CPU (the
#: reference's own single-device rwkv6 run is 8.6e-4 from its run on the
#: mesh).  Parameters stay within ``TOL``.
MOMENT_DRIFT_TOL = 1e-2
#: the key of the first moment after the first step, kept for every case
FIRST_PREFIX = "opt/.mu/"
#: the meshes of ``drift``: one device, and the other shapes of 8
DRIFT_MESHES = ((1, 1), (1, 8), (4, 2), (8, 1))
#: the bounds past the first step of the cases that drift, by quantity
#: (``loss``, ``grad_norm``, ``params``, ``moments``), each at least the
#: reference's own drift (``--drift``: its runs on ``DRIFT_MESHES``
#: against the file's), largest over the meshes, measured on the CPU
#: (ROADMAP §C 19); the first step of every case stays within
#: ``LOSS_TOL`` and ``TOL`` but for seamless's first moments:
DRIFT_BOUNDS = {
    # granite's later gradient norms (train_expected.py's DRIFT_TOL) and
    # moments, rwkv6's moments: as above
    "granite-moe-1b-a400m": dict(grad_norm=DRIFT_TOL,
                                 moments=MOMENT_DRIFT_TOL),
    "rwkv6-7b": dict(moments=MOMENT_DRIFT_TOL),
    # the reference's own moments drift 1.70e-3 (one device); the port's
    # ranks measured 1.53e-3
    "internvl2-2b": dict(moments=MOMENT_DRIFT_TOL),
    # without its clip (``CASE_TRAIN``) the reference's own moments drift
    # 6.59e-3 on one device (1.09e-1 on (8, 1)); the port's ranks
    # measured 3.64e-3.  Its loss, norms and parameters hold LOSS_TOL and
    # TOL:
    "zamba2-7b": dict(moments=MOMENT_DRIFT_TOL),
    # the seeded init (``ParamSpec.std``: 1 / sqrt of the second-to-last
    # dimension, the heads of a (d, heads, head_dim) projection) gives the
    # reduced encoder-decoder's wq, wk and wv a standard deviation of 0.5
    # and 0.71, so its attention logits have a standard deviation of 22
    # and reach 132 (no qk norm): the softmax is saturated (the top
    # probability 0.92-0.94 on average) and its backward cancels.  Its
    # float32 gradient at step 1 is 1.48e-3 (of a leaf's largest element)
    # from the same gradient in float64 (qwen3's 8.3e-7), and the
    # reference's meshes differ by 5.47e-3 in the first moments; AdamW
    # then steps every element by about its learning rate whatever the
    # gradient's size, so after step 3 its own drift is 5.58e-3 in the
    # loss, 2.17e-1 in the gradient norm, 1.25e-1 in the parameters and
    # 31 (relative) in the moments.  Without the clip it drifts more (the
    # gradient norm 1.77e2 against 73.1 on one device at step 3).  The
    # port's ranks measured 3.50e-3, 1.37e-3, 1.35e-1, 1.27e-1 and 14.6.
    # About twice the reference's own; its first step's loss and gradient
    # norm stay within LOSS_TOL and TOL:
    "seamless-m4t-large-v2": dict(first_moments=1e-2, loss=1e-2,
                                  grad_norm=5e-1, params=3e-1,
                                  moments=1e2),
}


def _reference_run(arch: str, size: str, microbatches: int,
                   mesh_shape=MESH) -> tuple:
    """The reference's ``jit_train_step`` on a (data, model) mesh of
    ``mesh_shape`` host devices for the case's batches: (the metrics'
    rows, the AdamW first moment after the first step and the state after
    the last, as full numpy arrays by checkpoint key)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import TrainConfig
    from repro.data import SyntheticLMData
    from repro.launch.mesh import auto_axis_types_kwargs
    from repro.models import get_model
    from repro.train import checkpoint as ckpt
    from repro.train.optimizer import adamw_init
    from repro.train.train_loop import jit_train_step
    from repro_torch.configs import ARCHS
    from repro_torch.models import get_model as port_model
    from repro_torch.models.module import init_params_numpy

    n = mesh_shape[0] * mesh_shape[1]
    devices = np.asarray(jax.devices()[:n]).reshape(mesh_shape)
    mesh = jax.sharding.Mesh(devices, ("data", "model"),
                             **auto_axis_types_kwargs(2))
    cfg = case_config(arch, size, REF_ARCHS)
    api = get_model(cfg)
    tc = case_train(arch, microbatches, TrainConfig)
    step, pspecs, opt_specs, _ = jit_train_step(api, tc, mesh)
    put = lambda t, s: jax.tree_util.tree_map(            # noqa: E731
        lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), t, s,
        is_leaf=lambda x: isinstance(x, P))
    params = put(jax.tree_util.tree_map(jnp.asarray, init_params_numpy(
        port_model(case_config(arch, size, ARCHS)).specs(), PARAM_SEED)),
        pspecs)
    opt = put(adamw_init(params), opt_specs)

    def arrays(state):
        flat, _ = ckpt._flatten(state)
        return {k: np.asarray(v) for k, v in flat.items()
                if k != "opt/.step"}

    rows, first = dict(loss=[], grad_norm=[], lr=[]), None
    for nb in case_batches(cfg, SyntheticLMData):
        b = {k: jnp.asarray(v) for k, v in nb.items()}
        params, opt, m = step(params, opt, b)
        for k in rows:
            rows[k].append(float(m[k]))
        if first is None:
            first = {k: v for k, v in arrays({"opt": opt}).items()
                     if k.startswith(FIRST_PREFIX)}
    return rows, first, arrays({"params": params, "opt": opt})


def by_position(arrays: dict, cfg) -> dict:
    """{``d<i>m<j>``: {key: ``summary``}} of full arrays by checkpoint key,
    cut into the blocks the (2, 4) mesh's specs of the port's config
    ``cfg`` give each position (the port's ``named_sharding``, which the
    CPU tests hold equal to the reference's ``devices_indices_map``)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import get_model as port_model
    from repro_torch.sharding import named_sharding
    from repro_torch.train.train_loop import (flatten_specs,
                                              shardings_for_train)
    mesh = Mesh({"data": MESH[0], "model": MESH[1]})
    pspecs, opt_specs, _ = shardings_for_train(port_model(cfg), mesh)
    specs = flatten_specs({"params": pspecs, "opt": opt_specs})
    out = {}
    for r in range(mesh.size):
        c = mesh.coords_of(r)
        out[f"d{c['data']}m{c['model']}"] = {
            k: summary(named_sharding(mesh, specs[k]).block(v, c))
            for k, v in arrays.items()}
    return out


def _reference_case(arch: str, size: str, microbatches: int,
                    mesh_shape=MESH) -> dict:
    """A reference run in the file's layout (``_reference_run``)."""
    from repro_torch.configs import ARCHS
    rows, first, final = _reference_run(arch, size, microbatches,
                                        mesh_shape)
    cfg = case_config(arch, size, ARCHS)
    return dict(rows, shards=by_position(final, cfg),
                first_mu=by_position(first, cfg))


def drift(index: int) -> dict:
    """The reference's own drift in case ``index``: ``compare`` of its
    runs on the other meshes of 8 host devices and on one device against
    its (2, 4) run, the file's."""
    arch, size, mb = CASES[index]
    want = json.loads(OUT.read_text())["cases"][case_name(*CASES[index])]
    out = {}
    for shape in DRIFT_MESHES:
        out["x".join(map(str, shape))] = compare(
            _reference_case(arch, size, mb, shape), want)
    return out


def _shard_errs(got: dict, want: dict, out: dict, prefix: str = "") -> None:
    """The largest relative differences of shard records by position
    (``compare``) into ``out``, under ``prefix``."""
    if sorted(got) != sorted(want):
        raise ValueError("the mesh positions differ")
    for pos, leaves in want.items():
        mine = got[pos]
        if sorted(mine) != sorted(leaves):
            raise ValueError(f"{pos}: the keys differ: "
                             f"{sorted(set(mine) ^ set(leaves))}")
        for key, w in leaves.items():
            g = mine[key]
            if list(g["shape"]) != list(w["shape"]):
                raise ValueError(f"{pos} {key}: shape {g['shape']}, the "
                                 f"reference's {w['shape']}")
            kind = prefix + ("params" if key.startswith("params/")
                             else "moments")
            sq = abs(g["sumsq"] - w["sumsq"]) / max(w["sumsq"], 1e-30)
            wv = np.asarray(w["vals"])
            vals = float(np.max(np.abs(np.subtract(g["vals"], wv)))) / \
                max(float(np.max(np.abs(wv))), 1e-30)
            out[f"{kind}_sumsq"] = max(out.get(f"{kind}_sumsq", 0.0), sq)
            out[f"{kind}_vals"] = max(out.get(f"{kind}_vals", 0.0), vals)


def compare(got: dict, want: dict) -> dict:
    """The largest relative difference of each quantity of one case:
    ``loss``, ``grad_norm``, ``lr`` (each against its own magnitude, the
    largest over the steps), ``loss_first`` and ``grad_norm_first`` (the
    first step's), over every position's shard of every parameter
    (``params_*``) and every AdamW moment (``moments_*``) after the last
    step, and of the first moment after the first step (``first_moments_*``,
    the clipped gradient), the sum of squares (``*_sumsq``, against its
    own magnitude) and the values (``*_vals``, against the values' largest
    magnitude).  A shard whose shape differs, or a position or key missing
    on either side, raises ``ValueError``."""
    out = {}
    for k in ("loss", "grad_norm", "lr"):
        a, b = np.asarray(got[k]), np.asarray(want[k])
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
        out[k] = float(np.max(rel))
        if k != "lr":
            out[f"{k}_first"] = float(rel[0])
    for k in ("params_sumsq", "params_vals", "moments_sumsq",
              "moments_vals"):
        out[k] = 0.0
    _shard_errs(got["shards"], want["shards"], out)
    _shard_errs(got["first_mu"], want["first_mu"], out, "first_")
    return out


def over_tolerance(arch: str, err: dict) -> list:
    """The quantities of ``compare``'s result beyond their tolerance, as
    ``"name value > tolerance"`` strings (empty when the case holds): the
    first step's at ``LOSS_TOL`` and ``TOL`` for every case, the later
    ones at the case's ``DRIFT_BOUNDS`` where it has them."""
    wide = DRIFT_BOUNDS.get(arch, {})
    tols = dict(loss_first=LOSS_TOL, grad_norm_first=TOL, lr=LOSS_TOL,
                loss=wide.get("loss", LOSS_TOL),
                grad_norm=wide.get("grad_norm", TOL))
    for kind in ("first_moments", "params", "moments"):
        for q in ("sumsq", "vals"):
            tols[f"{kind}_{q}"] = wide.get(kind, TOL)
    return [f"{k} {err[k]:.3e} > {t:.0e}" for k, t in tols.items()
            if not err[k] <= t]


def _setup() -> None:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count="
            f"{MESH[0] * MESH[1]}").strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", type=int, default=None,
                    help="print this case's record instead of writing")
    ap.add_argument("--drift", type=int, default=None,
                    help="print this case's reference drift (``drift``)")
    args = ap.parse_args(argv)
    _setup()
    import jax
    if args.case is not None:
        print(json.dumps(_reference_case(*CASES[args.case])))
        return
    if args.drift is not None:
        print(json.dumps(drift(args.drift)))
        return
    out = dict(
        config=dict(mesh=list(MESH), cases=[list(c) for c in CASES],
                    steps=STEPS, batch=BATCH, seq=SEQ, param_seed=PARAM_SEED,
                    data_seed=DATA_SEED, train=TRAIN, case_train=CASE_TRAIN,
                    slice=SLICE,
                    jax=jax.__version__),
        cases={case_name(*c): _reference_case(*c) for c in CASES})
    OUT.write_text(json.dumps(out, sort_keys=True, separators=(",", ":"))
                   + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
