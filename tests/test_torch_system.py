"""End-to-end system behaviour of the port on the CPU, the non-dry-run
cases of ``test_system.py``: fault-tolerant training on the real data
pipeline, and EDAN analysing the framework's own train step (the paper's
loop closed) — the loss, as the reference's test traces it, and the whole
step (loss, gradient and AdamW update, ``tracing.trace_train_step``), the
analysis the card runs in ``chip_smoke.py`` phase "train"."""
import numpy as np
import torch

from repro_torch.configs import ARCHS, TrainConfig
from repro_torch.core import CostModelParams, edag_from_fn, report
from repro_torch.data import SyntheticLMData
from repro_torch.models import get_model
from repro_torch.models.tracing import trace_train_step
from repro_torch.train.fault import FaultTolerantLoop
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_loop import make_train_step


def test_fault_tolerant_training_run(tmp_path, monkeypatch):
    """Train a reduced model under injected failures; loss decreases and the
    loop replays cleanly from checkpoints."""
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    cfg = ARCHS["granite-moe-1b-a400m"].reduced()
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    opt = adamw_init(params)
    tc = TrainConfig(lr=3e-3, warmup_steps=3, total_steps=30, z_loss=0.0)
    step = make_train_step(api, tc)
    data = SyntheticLMData(vocab_size=cfg.padded_vocab(), seq_len=32,
                           global_batch=4, seed=1)
    losses = []

    def step_fn(state, s):
        p, o = state["params"], state["opt"]
        b = {k: torch.from_numpy(v) for k, v in data.batch(s).items()}
        p, o, m = step(p, o, b)
        losses.append(float(m["loss"]))
        return {"params": p, "opt": o}

    seen = set()

    def inject(s):
        if s == 12 and s not in seen:
            seen.add(s)
            return True
        return False

    loop = FaultTolerantLoop({"params": params, "opt": opt},
                             str(tmp_path / "ck"), save_every=5,
                             inject_failure=inject)
    loop.run(step_fn, 25)
    assert loop.restarts == 1
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def _coherent(r) -> None:
    assert r.W > 0 and r.D >= 1
    assert r.W >= r.D
    assert 0 <= r.Lam <= 1
    assert r.parallelism >= 1.0


def test_edan_analyzes_own_train_step(monkeypatch):
    """PyTorch-graph eDAG of the framework's loss produces coherent paper
    metrics (W, D, lambda, bounded Lambda)."""
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    cfg = ARCHS["qwen3-0.6b"].reduced()
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32),
             "labels": torch.zeros((2, 16), dtype=torch.int32)}
    g = edag_from_fn(lambda p, b: api.loss_fn(p, b), params, batch,
                     mem_threshold_bytes=1024, scan_unroll_limit=8)
    assert g.n_vertices > 30
    _coherent(report(g, CostModelParams(m=8, alpha=200.0)))


def test_edan_analyzes_the_whole_train_step(monkeypatch):
    """The whole step — loss, gradient, AdamW — traced from meta inputs:
    more vertices than the loss alone, the optimizer's update among them,
    and coherent metrics."""
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    g = trace_train_step("qwen3-0.6b")
    labels = set(g.labels())
    assert g.n_vertices > 1000
    assert {"sqrt", "pow"} <= labels
    _coherent(report(g))
