"""The port's int8 gradient compression (``repro_torch.train.compression``)
against the reference package on the CPU: every case of
``test_compression.py`` through the port (one rank: no process group);
``quantize_int8`` and ``compressed_psum_local`` equal to the reference's
on the same inputs; and the all-reduce across two ``gloo`` ranks equal
to the arithmetic on the gathered gradients."""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.launch.mesh import auto_axis_types_kwargs
from repro.train import compression as ref
from repro_torch.train.compression import (compressed_psum_local,
                                           dequantize_int8, init_error_state,
                                           make_dp_train_step, quantize_int8)

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------- the cases of test_compression.py

def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        256).astype(np.float32)) * 10
    q, s = quantize_int8(x)
    assert q.dtype == torch.int8
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6


def test_error_feedback_accumulates():
    """With error feedback, the *running sum* of dequantized payloads tracks
    the running sum of true gradients (bias-free compression)."""
    rng = np.random.default_rng(0)
    err = torch.zeros(64)
    total_true = np.zeros(64)
    total_sent = np.zeros(64)
    for i in range(30):
        g = torch.from_numpy(rng.standard_normal(64) * 0.01).float()
        total_true += g.numpy()
        target = g + err
        q, s = quantize_int8(target)
        sent = dequantize_int8(q, s)
        err = target - sent
        total_sent += sent.numpy()
    assert np.abs(total_sent - total_true).max() < 1e-3


def test_dp_train_step_compressed_matches_uncompressed():
    """On a tiny regression problem, the compressed DP step converges to the
    same loss as the exact step (error feedback keeps it unbiased)."""
    W = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (8, 1)).astype(np.float32)) * 0.5

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2)

    def update_fn(params, grads, opt):
        return ({"w": params["w"] - 0.05 * grads["w"]}, opt)

    def run(compress):
        params = {"w": torch.zeros((8, 1))}
        err = init_error_state(params)
        step = make_dp_train_step(loss_fn, update_fn, compress=compress)
        rng = np.random.default_rng(1)
        losses = []
        for i in range(120):
            x = torch.from_numpy(rng.standard_normal((16, 8))).float()
            y = x @ W + 0.01 * torch.from_numpy(
                rng.standard_normal((16, 1))).float()
            params, _, err, l = step(params, None, err, {"x": x, "y": y})
            losses.append(float(l))
        return params, losses

    p_c, l_c = run(True)
    p_u, l_u = run(False)
    assert l_c[-1] < 0.01 and l_u[-1] < 0.01
    np.testing.assert_allclose(p_c["w"].numpy(), p_u["w"].numpy(), atol=0.05)


def test_compressed_psum_local_single_device():
    """One rank: payload == mean == input (+residual)."""
    g = {"w": torch.from_numpy(np.linspace(-1, 1, 32).astype(np.float32))}
    e = init_error_state(g)
    out, err = compressed_psum_local(g, e)
    np.testing.assert_allclose(out["w"].numpy(), g["w"].numpy(), atol=0.02)
    np.testing.assert_allclose((out["w"] + err["w"]).numpy(),
                               g["w"].numpy(), atol=1e-6)


# ------------------------------------------------------ the reference

def test_equal_to_the_reference_on_one_device():
    """``quantize_int8`` bit for bit, and ``compressed_psum_local`` (the
    reference inside ``shard_map`` over one device) equal, with error
    feedback carried over three rounds."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 7)).astype(np.float32) * 3
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = ref.quantize_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    mesh = jax.make_mesh((1,), ("data",), **auto_axis_types_kwargs(1))
    P = jax.sharding.PartitionSpec
    rfn = ref._smap(lambda g, e: ref.compressed_psum_local(g, e, "data"),
                    mesh, (P(), P()), (P(), P()))
    e, re = init_error_state({"w": torch.zeros(7)}), {"w": jnp.zeros(7)}
    for i in range(3):
        g = rng.standard_normal(7).astype(np.float32)
        out, e = compressed_psum_local({"w": torch.from_numpy(g)}, e)
        rout, re = rfn({"w": jnp.asarray(g)}, re)
        np.testing.assert_array_equal(out["w"].numpy(), np.asarray(rout["w"]))
        np.testing.assert_array_equal(e["w"].numpy(), np.asarray(re["w"]))


_TWO_RANKS = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.train.compression import compressed_psum_local
    rank, port = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    g = np.random.default_rng(rank).standard_normal((3, 5)).astype(np.float32)
    e = np.random.default_rng(10 + rank).standard_normal((3, 5)).astype(
        np.float32) * 1e-3
    out, err = compressed_psum_local({"w": torch.from_numpy(g)},
                                     {"w": torch.from_numpy(e)})
    np.save(sys.argv[3], np.stack([out["w"].numpy(), err["w"].numpy()]))
    dist.destroy_process_group()
''')


def test_two_ranks_over_gloo(tmp_path):
    """Two ``gloo`` ranks: each gets the mean of the int8 payloads at the
    shared (MAX) scale, and its own residual, as computed here from both
    ranks' gradients."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS, str(r),
                               str(port), str(tmp_path / f"r{r}.npy")],
                              env=env) for r in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    targets = [np.random.default_rng(r).standard_normal((3, 5)).astype(
        np.float32) + np.random.default_rng(10 + r).standard_normal(
        (3, 5)).astype(np.float32) * np.float32(1e-3) for r in range(2)]
    scale = max(np.float32(max(np.abs(t).max(), 1e-12)) / np.float32(127.0)
                for t in targets)
    qs = [np.clip(np.round(t / scale), -127, 127) for t in targets]
    mean = (qs[0] + qs[1]).astype(np.float32) * scale / np.float32(2)
    for r in range(2):
        out, err = np.load(tmp_path / f"r{r}.npy")
        np.testing.assert_allclose(out, mean, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(err, targets[r] - qs[r] * scale,
                                   rtol=1e-6, atol=1e-7)
