"""The port's checkpoints and fault-tolerant loop (``repro_torch.train.
checkpoint``, ``fault``) against the reference package on the CPU: every
case of ``test_checkpoint.py`` through the port; the same file names, the
same ``meta.json`` and the same ``.npy`` bytes for the same tree (bf16 and
``AdamState`` leaves included); a checkpoint written by either package
restored by the other, leaf for leaf; the async save's host snapshot; and
the four faults of the reference's ``fault.py`` that the port does not
copy (ROADMAP §C), each shown on the reference and held on the port in a
child process (signals need a process of their own)."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import checkpoint as ref_ckpt
from repro.train.optimizer import AdamState as RefAdamState
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import FaultTolerantLoop, StragglerStats
from repro_torch.train.optimizer import AdamState

ROOT = Path(__file__).resolve().parents[1]


def tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.bfloat16)},
            "step_count": torch.tensor(5, dtype=torch.int32)}


def _leaves(t):
    return list(ckpt._flatten(t).values())


# --------------------------------------- the cases of test_checkpoint.py

def test_roundtrip(tmp_path):
    t = tree()
    ckpt.save(t, str(tmp_path), step=3)
    got, meta = ckpt.restore(t, str(tmp_path))
    assert meta["step"] == 3
    for a, b in zip(_leaves(t), _leaves(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_latest_and_gc(tmp_path):
    t = tree()
    for s in (1, 2, 3, 4):
        ckpt.save(t, str(tmp_path), step=s, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    steps = sorted(os.listdir(tmp_path))
    assert steps == ["step_00000003", "step_00000004"]


def test_no_tmp_dirs_left(tmp_path):
    ckpt.save(tree(), str(tmp_path), step=1)
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_async_save(tmp_path):
    th = ckpt.save_async(tree(), str(tmp_path), step=9)
    th.join()
    assert ckpt.latest_step(str(tmp_path)) == 9


def test_restore_onto_a_device(tmp_path):
    """The counterpart of the reference's restore with shardings: every
    leaf lands on the device asked for; a ``meta`` template (no data)
    loads onto the host."""
    t = tree()
    ckpt.save(t, str(tmp_path), step=1)
    got, _ = ckpt.restore(t, str(tmp_path), device="cpu")
    assert all(x.device.type == "cpu" for x in _leaves(got))
    meta_t = {"a": torch.empty((2, 3), device="meta"),
              "nested": {"b": torch.empty(4, dtype=torch.bfloat16,
                                          device="meta")},
              "step_count": torch.empty((), dtype=torch.int32, device="meta")}
    got, _ = ckpt.restore(meta_t, str(tmp_path))
    for a, b in zip(_leaves(t), _leaves(got)):
        assert b.device.type == "cpu" and torch.equal(a, b)


def test_fault_loop_recovers_from_injected_failures(tmp_path):
    """Failures at arbitrary steps must replay from the last checkpoint and
    still produce the exact same final state as a failure-free run."""
    def step_fn(state, s):
        return {"x": state["x"] + s}

    def run(name, inject):
        loop = FaultTolerantLoop({"x": torch.tensor(0.0)},
                                 str(tmp_path / name), save_every=3,
                                 inject_failure=inject)
        return loop.run(step_fn, 10)

    clean = run("clean", None)
    fails = {4: True, 8: True}
    seen = set()

    def inject(s):
        if s in fails and s not in seen:
            seen.add(s)
            return True
        return False
    faulty = run("faulty", inject)
    assert float(clean["x"]) == float(faulty["x"]) == sum(range(10))


def test_fault_loop_resumes_across_instances(tmp_path):
    def step_fn(state, s):
        return {"x": state["x"] + 1}
    d = str(tmp_path / "resume")
    loop1 = FaultTolerantLoop({"x": torch.tensor(0.0)}, d, save_every=2)
    loop1.run(step_fn, 4)
    loop2 = FaultTolerantLoop({"x": torch.tensor(0.0)}, d, save_every=2)
    assert loop2.start_step == 4
    out = loop2.run(step_fn, 7)
    assert float(out["x"]) == 7


def test_straggler_stats():
    st = StragglerStats(window=10, k=3.0)
    for _ in range(8):
        assert not st.record(1.0)
    assert st.record(10.0)
    assert st.flagged == 1


# -------------------------------------------- across the two packages

def _pair_trees():
    """The same tree in both packages: float32, bf16, int32 scalar and
    ``AdamState`` leaves."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 3)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    mu = rng.standard_normal((2, 3)).astype(np.float32)
    ref = {"params": {"a": jnp.asarray(a),
                      "nested": {"b": jnp.asarray(b, jnp.bfloat16)}},
           "opt": RefAdamState(mu={"a": jnp.asarray(mu)},
                               nu={"a": jnp.asarray(mu ** 2)},
                               step=jnp.int32(7)),
           "step_count": jnp.int32(5)}
    port = {"params": {"a": torch.from_numpy(a),
                       "nested": {"b": torch.from_numpy(b).to(
                           torch.bfloat16)}},
            "opt": AdamState(mu={"a": torch.from_numpy(mu)},
                             nu={"a": torch.from_numpy(mu ** 2)},
                             step=torch.tensor(7, dtype=torch.int32)),
            "step_count": torch.tensor(5, dtype=torch.int32)}
    return ref, port


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy().astype(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def test_same_files_and_meta_as_the_reference(tmp_path):
    ref, port = _pair_trees()
    ref_ckpt.save(ref, str(tmp_path / "ref"), 3, extra={"note": "x"})
    ckpt.save(port, str(tmp_path / "port"), 3, extra={"note": "x"})
    r, p = tmp_path / "ref" / "step_00000003", tmp_path / "port" / \
        "step_00000003"
    assert sorted(os.listdir(r)) == sorted(os.listdir(p))
    assert "opt__.mu__a.npy" in os.listdir(p)
    assert (r / "meta.json").read_text() == (p / "meta.json").read_text()
    meta = json.loads((p / "meta.json").read_text())
    assert meta["keys"] == ["opt/.mu/a", "opt/.nu/a", "opt/.step",
                            "params/a", "params/nested/b", "step_count"]
    assert meta["dtypes"] == {"params/nested/b": "bfloat16"}
    for name in os.listdir(r):
        assert (r / name).read_bytes() == (p / name).read_bytes(), name


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_restores_across_packages(tmp_path, writer):
    """A checkpoint written by either package restores in the other, leaf
    for leaf: values and dtypes (bf16 and the ``AdamState`` step too)."""
    ref, port = _pair_trees()
    if writer == "reference":
        ref_ckpt.save(ref, str(tmp_path), 4)
        got, meta = ckpt.restore(port, str(tmp_path))
        assert isinstance(got["opt"], AdamState)
        pairs = zip(jax.tree_util.tree_leaves(ref), _leaves(got))
        for want, leaf in pairs:
            assert leaf.dtype == {"bfloat16": torch.bfloat16,
                                  "float32": torch.float32,
                                  "int32": torch.int32}[str(want.dtype)]
            assert np.array_equal(_as_numpy(leaf), np.asarray(want))
    else:
        ckpt.save(port, str(tmp_path), 4)
        got, meta = ref_ckpt.restore(ref, str(tmp_path))
        assert isinstance(got["opt"], RefAdamState)
        for want, leaf in zip(_leaves(port), jax.tree_util.tree_leaves(got)):
            assert leaf.dtype == _as_numpy(want).dtype
            assert np.array_equal(np.asarray(leaf), _as_numpy(want))
    assert meta["step"] == 4


def test_save_async_snapshots_before_returning(tmp_path):
    """The tree is on the host before ``save_async`` returns: changing a
    tensor in place afterwards does not reach the checkpoint."""
    t = {"w": torch.zeros(1000)}
    th = ckpt.save_async(t, str(tmp_path), step=1)
    t["w"].add_(1.0)
    th.join()
    got, _ = ckpt.restore({"w": torch.empty(1000)}, str(tmp_path))
    assert float(got["w"].abs().max()) == 0.0


# ----------------------------------------- the reference's fault.py faults

_SCRIPT = textwrap.dedent('''
    import json, os, signal, sys, time
    pkg, scenarios, work = sys.argv[1], sys.argv[2].split(","), sys.argv[3]
    if pkg == "repro":
        import jax.numpy as jnp
        from repro.train import checkpoint as ckpt
        from repro.train.fault import FaultTolerantLoop
        zero = lambda: {"x": jnp.float32(0)}
    else:
        import torch
        from repro_torch.train import checkpoint as ckpt
        from repro_torch.train.fault import FaultTolerantLoop
        zero = lambda: {"x": torch.tensor(0.0)}
    caught = []
    if "python-prev" in scenarios:
        signal.signal(signal.SIGTERM, lambda s, f: caught.append(s))
    default = signal.getsignal(signal.SIGTERM)
    out = {}

    def emergency(d):
        """(label, x) of each emergency checkpoint in d."""
        rows = []
        for name in sorted(os.listdir(d)):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            meta = json.load(open(os.path.join(d, name, "meta.json")))
            if meta.get("extra", {}).get("emergency"):
                t, _ = ckpt.restore(zero(), d, step=meta["step"])
                rows.append([meta["step"], float(t["x"])])
        return rows

    def inc(state, s):
        return {"x": state["x"] + 1}

    if "before-run" in scenarios:
        d = os.path.join(work, "before")
        loop = FaultTolerantLoop(zero(), d, save_every=0)
        try:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.05)
            out["before_run"] = "no error"
        except AttributeError as e:
            out["before_run"] = "AttributeError"
        out["before_run_saved"] = emergency(d)
        loop.run(inc, 1)
    if "after-run" in scenarios:
        d = os.path.join(work, "after")
        FaultTolerantLoop(zero(), d, save_every=0).run(inc, 2)
        out["handler_after_run_restored"] = \\
            signal.getsignal(signal.SIGTERM) == default
    if "replay" in scenarios:
        d = os.path.join(work, "replay")
        seen = set()

        def fail_once(s):
            if s == 3 and s not in seen:
                seen.add(s)
                return True
            return False

        def step(state, s):
            if s == 2 and seen:           # the replay after the restore
                os.kill(os.getpid(), signal.SIGTERM)
                time.sleep(0.05)
            return inc(state, s)
        FaultTolerantLoop(zero(), d, save_every=2, keep=10,
                          inject_failure=fail_once).run(step, 5)
        out["replay_emergency"] = emergency(d)
    if "terminate" in scenarios:
        d = os.path.join(work, "terminate")

        def step(state, s):
            if s == 2:
                os.kill(os.getpid(), signal.SIGTERM)
                time.sleep(0.05)
            return inc(state, s)
        print(json.dumps(out), flush=True)
        FaultTolerantLoop(zero(), d, save_every=0).run(step, 4)
        out["terminate"] = "finished"
    out["caught"] = len(caught)
    print(json.dumps(out), flush=True)
''')


def _child(pkg: str, scenarios: str, work: Path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _SCRIPT, pkg, scenarios,
                          str(work)], capture_output=True, text=True,
                         env=env, timeout=120)
    lines = [json.loads(x) for x in res.stdout.splitlines()
             if x.startswith("{")]
    return res.returncode, lines, res.stderr


def test_reference_fault_py_faults_are_real(tmp_path):
    """On the reference: a SIGTERM before ``run`` raises
    ``AttributeError``; the handler outlives the loop; a SIGTERM under the
    default disposition does not end the process; an emergency save in a
    replay labels the restored state (2 steps) with the failed attempt's
    step (3)."""
    rc, lines, err = _child("repro", "before-run,after-run,replay,terminate",
                            tmp_path)
    assert rc == 0, err
    out = lines[-1]
    assert out["before_run"] == "AttributeError"
    assert out["before_run_saved"] == []
    assert out["handler_after_run_restored"] is False
    assert out["replay_emergency"] == [[3, 2.0]]
    assert out["terminate"] == "finished"


def test_port_saves_on_sigterm_before_run_and_restores_the_handler(tmp_path):
    """On the port, with a Python handler installed before the loop: a
    SIGTERM before ``run`` saves the state at step 0 and reaches the
    previous handler; after ``run`` the previous handler is back; an
    emergency save during a replay is labelled with the restored state's
    step."""
    rc, lines, err = _child("repro_torch", "python-prev,before-run,"
                            "after-run,replay", tmp_path)
    assert rc == 0, err
    out = lines[-1]
    assert out["before_run"] == "no error"
    assert out["before_run_saved"] == [[0, 0.0]]
    assert out["handler_after_run_restored"] is True
    assert out["replay_emergency"] == [[2, 2.0]]
    assert out["caught"] == 2


def test_port_sigterm_saves_then_ends_the_process(tmp_path):
    """On the port, under the default disposition: the emergency save,
    then the process ends by the signal, as it would without the loop."""
    rc, lines, err = _child("repro_torch", "terminate", tmp_path)
    assert rc == -15, (rc, err)
    assert lines == [{}]
    d = tmp_path / "terminate" / "step_00000002"
    meta = json.loads((d / "meta.json").read_text())
    assert meta["extra"] == {"emergency": True}
