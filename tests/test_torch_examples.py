"""The examples' twins (``repro_torch.examples``) at their reduced sizes on
the CPU, each against the JAX package's functions its JAX counterpart
(``examples/*.py``) calls, on the same inputs:

* ``quickstart``: the scalar traces' reports, the PyTorch function's
  eDAG (the jaxpr's of the same function) and the bounds-vs-simulation
  rows equal the JAX package's;
* ``latency_sensitivity --reduced --hlo``: the PolyBench ranking and the
  HPCG cache study equal the JAX package's at the same sizes, and the
  per-axis collective analyses of the recorded compiled texts equal the
  reference's on the same texts;
* ``serve_lm``: every request finishes with its tokens, as many as asked;
* ``train_lm --scale tiny``: three steps with finite losses, a
  checkpoint, and an eDAG of the step.
"""
import gzip

import jax.numpy as jnp
import numpy as np
import pytest

from repro import core as J
from repro.apps import hpcg as jhpcg, polybench as jpolybench
from repro_torch.examples import (latency_sensitivity, quickstart, serve_lm,
                                  train_lm)


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")


def _row(r):
    return (r.W, r.D, r.lam, r.Lam)


def test_quickstart_equals_the_references():
    lines = []
    out = quickstart.main(["--device", "cpu"], emit=lines.append)
    rng = np.random.default_rng(0)
    tr = J.Tracer()
    a = tr.array(rng.standard_normal(64), "a")
    b = tr.array(rng.standard_normal(64), "b")
    acc = tr.const(0.0)
    for i in range(64):
        acc = tr.alu('+', acc, tr.alu('*', a.load(i), b.load(i)))
    assert _row(out["dot"]) == _row(J.report(tr.edag))
    assert (out["chase"].W, out["chase"].D) == (64, 64)
    assert out["cached"].W == 8

    def f(x, w1, w2):
        return (jnp.tanh(x @ w1) @ w2).sum()

    g = J.edag_from_fn(f, jnp.ones((32, 64)), jnp.ones((64, 128)),
                       jnp.ones((128, 8)), mem_threshold_bytes=1024)
    assert out["graph"].n_vertices == g.n_vertices
    want = J.report(g, J.CostModelParams(m=4, alpha=200.0))
    assert _row(out["graph_report"]) == _row(want)
    assert [r[0] for r in out["bounds"]] == [50, 100, 200, 300]
    for alpha, lo, sim, hi in out["bounds"]:
        assert lo <= sim <= hi
    assert any(line.startswith("d(sim)/d(alpha)") for line in
               "\n".join(lines).splitlines())


def test_latency_sensitivity_equals_the_references():
    out = latency_sensitivity.main(["--device", "cpu", "--reduced",
                                    "--hlo"], emit=lambda _: None)
    want = []
    for name in jpolybench.PAPER_15:
        lay = jpolybench.trace_kernel(name, 6).mem_layers()
        want.append((J.lambda_abs(lay.W, lay.D, 4), name, lay.W, lay.D))
    assert out["polybench"] == sorted(want, reverse=True)
    for cs, lam, sweep in out["hpcg"]:
        g, _ = jhpcg.trace_cg(n=4, iters=2, cache=J.make_cache(cs))
        assert lam == J.report(g, J.CostModelParams(m=4, alpha=200.0)).lam
        assert sweep == list(J.latency_sweep(g, [50, 150, 300], m=4))
    for name, axes in latency_sensitivity.HLO_STEPS:
        text = gzip.decompress((latency_sensitivity.HLO / name)
                               .read_bytes()).decode()
        ref = J.collective_sensitivity(text, axes)["per_axis"]
        got = out["hlo"][name]
        assert set(got) == set(ref)
        for ax in ref:
            assert got[ax].row() == ref[ax].row(), (name, ax)


def test_serve_lm_runs():
    out = serve_lm.main(["--device", "cpu", "--requests", "3",
                         "--max-tokens", "4"], emit=lambda _: None)
    assert out["requests"] == 3 and out["tokens"] == 12
    assert all(len(r.output) == 4 for r in out["done"])


def test_train_lm_runs(tmp_path):
    out = train_lm.main(["--device", "cpu", "--scale", "tiny", "--steps",
                         "3", "--batch", "2", "--seq", "32", "--ckpt-dir",
                         str(tmp_path)], emit=lambda _: None)
    assert out["steps"] == 3 and len(out["losses"]) == 3
    assert np.isfinite(out["losses"]).all()
    assert any(tmp_path.iterdir())
    assert out["edag"].n_vertices > 0
