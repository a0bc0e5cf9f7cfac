"""Write the reference package's sharded training results, for the PyTorch
port's sharded train step (``repro_torch.train.train_loop.jit_train_step``
over ``torch.distributed`` ranks) to be held to, on the CPU and on the
card.

The reference's ``jit_train_step`` runs on 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``) on a (2, 4)
(data, model) mesh, float32, for ``STEPS`` steps of ``TRAIN``'s settings
on ``SyntheticLMData(seed=0)`` batches of ``BATCH`` x ``SEQ`` tokens.
Its weights are seeded numpy arrays from
``repro_torch.models.module.init_params_numpy`` (the port's specs, which
the CPU tests hold equal to the reference's), so both packages start from
the same weights.  ``CASES``:

* reduced qwen3-0.6b, whose 2 KV heads are replicated on the 4-way
  ``model`` axis, with ``microbatches`` 1 and 2;
* ``tests/test_dryrun_small.py``'s qwen3 (3 layers, d 128, 8 heads, 4 KV
  heads that divide the axis, vocabulary 512), here in float32;
* reduced granite-moe-1b-a400m (the MoE layer's "tp" ``shard_map``);
* reduced rwkv6-7b (the port's generic path), without the gradient clip
  (``CASE_TRAIN``: its seeded bonus ``u`` has a gradient of norm 5.8e5,
  whose clip would put every other element's step in AdamW's ``eps``
  regime, where two roundings of the same step differ by 4e-2 of a
  parameter leaf on the card).

The file keeps, per case, each step's loss, gradient norm and learning
rate, and after the last step, for each mesh position ``d<i>m<j>`` (the
device at ``mesh.devices[i, j]``, the port's rank ``4 i + j``), its
shard of every parameter and AdamW moment, by checkpoint key
(``params/...``, ``opt/.mu/...``, ``opt/.nu/...``): the shard's shape,
its float64 sum of squares and ``SLICE`` evenly spaced values of it,
flattened.

``summary`` makes that record of a shard; ``compare`` measures the port's
against the file and ``over_tolerance`` holds it: every loss and learning
rate within ``LOSS_TOL`` relative, the gradient norms and the shards
within ``tools/train_expected.py``'s ``TOL``; for the MoE case's gradient
norms after its first step ``DRIFT_TOL``, and for the moments of the MoE
and rwkv6 cases ``MOMENT_DRIFT_TOL`` (ROADMAP §C 19).

Writes ``src/repro_torch/configs/shard_expected.json``.  ``--case N``
prints case N's record as JSON instead (the CPU tests' live check).

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
    STEPS, TRAIN, case_config, case_name, case_train, summary)

TOL, DRIFT_TOL, DRIFTS = TE.TOL, TE.DRIFT_TOL, TE.DRIFTS
LOSS_TOL = 1e-5
#: the AdamW moments after the last step of the two cases whose float32
#: gradients drift (ROADMAP §C 19): the port's against the file measured
#: 4.1e-3 (granite-moe, its routing) and 3.3e-3 (rwkv6) on the CPU (the
#: reference's own single-device rwkv6 run is 8.6e-4 from its run on the
#: mesh).  Parameters stay within ``TOL``.
MOMENT_DRIFT_TOL = 1e-2
MOMENT_DRIFTS = ("granite-moe-1b-a400m", "rwkv6-7b")


def _reference_case(arch: str, size: str, microbatches: int) -> dict:
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

    n = MESH[0] * MESH[1]
    devices = np.asarray(jax.devices()[:n]).reshape(MESH)
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
    data = SyntheticLMData(vocab_size=cfg.padded_vocab(), seq_len=SEQ,
                           global_batch=BATCH, seed=DATA_SEED)
    rows = dict(loss=[], grad_norm=[], lr=[])
    for s in range(STEPS):
        b = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
        params, opt, m = step(params, opt, b)
        for k in rows:
            rows[k].append(float(m[k]))
    flat, _ = ckpt._flatten({"params": params, "opt": opt})
    shards = {f"d{i}m{j}": {} for i, j in np.ndindex(*MESH)}
    for key, leaf in flat.items():
        if key == "opt/.step":
            continue
        for sh in leaf.addressable_shards:
            i, j = (int(c) for c in np.argwhere(devices == sh.device)[0])
            shards[f"d{i}m{j}"][key] = summary(sh.data)
    return dict(rows, shards=shards)


def compare(got: dict, want: dict) -> dict:
    """The largest relative difference of each quantity of one case:
    ``loss``, ``grad_norm``, ``lr`` (each against its own magnitude),
    ``grad_norm_first``, and over every position's shard of every
    parameter (``params_*``) and every AdamW moment (``moments_*``) the
    sum of squares (``*_sumsq``, against its own magnitude) and the values
    (``*_vals``, against the values' largest magnitude).  A shard whose
    shape differs, or a position or key missing on either side, raises
    ``ValueError``."""
    out = {}
    for k in ("loss", "grad_norm", "lr"):
        a, b = np.asarray(got[k]), np.asarray(want[k])
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
        out[k] = float(np.max(rel))
        if k == "grad_norm":
            out["grad_norm_first"] = float(rel[0])
    if sorted(got["shards"]) != sorted(want["shards"]):
        raise ValueError("the mesh positions differ")
    for k in ("params_sumsq", "params_vals", "moments_sumsq",
              "moments_vals"):
        out[k] = 0.0
    for pos, leaves in want["shards"].items():
        mine = got["shards"][pos]
        if sorted(mine) != sorted(leaves):
            raise ValueError(f"{pos}: the keys differ: "
                             f"{sorted(set(mine) ^ set(leaves))}")
        for key, w in leaves.items():
            g = mine[key]
            if list(g["shape"]) != list(w["shape"]):
                raise ValueError(f"{pos} {key}: shape {g['shape']}, the "
                                 f"reference's {w['shape']}")
            kind = "params" if key.startswith("params/") else "moments"
            sq = abs(g["sumsq"] - w["sumsq"]) / max(w["sumsq"], 1e-30)
            wv = np.asarray(w["vals"])
            vals = float(np.max(np.abs(np.subtract(g["vals"], wv)))) / \
                max(float(np.max(np.abs(wv))), 1e-30)
            out[f"{kind}_sumsq"] = max(out[f"{kind}_sumsq"], sq)
            out[f"{kind}_vals"] = max(out[f"{kind}_vals"], vals)
    return out


def over_tolerance(arch: str, err: dict) -> list:
    """The quantities of ``compare``'s result beyond their tolerance, as
    ``"name value > tolerance"`` strings (empty when the case holds)."""
    moments = MOMENT_DRIFT_TOL if arch in MOMENT_DRIFTS else TOL
    tols = dict(loss=LOSS_TOL, lr=LOSS_TOL, grad_norm_first=TOL,
                grad_norm=DRIFT_TOL if arch in DRIFTS else TOL,
                params_sumsq=TOL, params_vals=TOL, moments_sumsq=moments,
                moments_vals=moments)
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
    args = ap.parse_args(argv)
    _setup()
    import jax
    if args.case is not None:
        print(json.dumps(_reference_case(*CASES[args.case])))
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
