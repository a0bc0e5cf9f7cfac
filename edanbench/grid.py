"""What the closed-loop sweep drivers share: one client that runs one
alpha x m x compute-slots grid after another over the configuration's
traces, keeps every step's answers, and has them compared with the
reference at points drawn from the seed."""
from __future__ import annotations

import traceback

import numpy as np
import torch

from . import check, harness, work


def alphas_of(grid: dict) -> np.ndarray:
    """The traffic's alpha axis: ``{"linspace": [lo, hi, n]}`` or a list."""
    a = grid["alphas"]
    if isinstance(a, dict):
        lo, hi, n = a["linspace"]
        return np.linspace(float(lo), float(hi), int(n))
    return np.asarray(a, dtype=np.float64)


class GridDriver:
    """A closed loop of one client; subclasses give ``prepare`` (built
    once in set-up) and ``compute`` (one step: ``{trace: (alphas, ms,
    slots) array}``)."""

    def __init__(self, ctx):
        self.ctx = ctx
        g = ctx.traffic["grid"]
        self.alphas = alphas_of(g)
        self.ms = tuple(int(m) for m in g["ms"])
        self.css = tuple(int(c) for c in g["compute_slots"])
        self.unit = float(ctx.cfg.get("unit", 1.0))
        self.sizes = {k: (g.n_vertices, g.n_edges, int(g.is_mem.sum()))
                      for k, g in ctx.traces.items()}
        self.points = len(self.sizes) * len(self.alphas) * len(self.ms) \
            * len(self.css)
        self.order = [str(k) for k in np.random.default_rng(
            [ctx.seed, 1]).permutation(sorted(ctx.traces))]
        self.steps: list = []
        self.failed = 0

    def prepare(self) -> None:
        pass

    def compute(self, alphas=None) -> dict:
        """One grid over ``alphas`` (the traffic's axis by default)."""
        raise NotImplementedError

    def setup(self) -> None:
        """Build what the steps share, then one warm step: over the whole
        grid, or over its first ``warm.alphas`` alphas where the traffic
        says so (a step that leaves the program in the state a whole step
        leaves it in, without the recordings that serve no answer)."""
        self.prepare()
        n = self.ctx.traffic.get("warm", {}).get("alphas")
        self.compute(self.alphas[:n] if n else None)

    def step(self) -> int:
        with torch.profiler.record_function("edanbench.step"):
            try:
                out = self.compute()
            except Exception:
                traceback.print_exc(file=self.ctx.log)
                self.steps.append(None)
                self.failed += self.points
                return 0
        self.steps.append(out)
        return self.points

    def window(self, seconds: float) -> dict:
        f0 = self.failed
        w = harness.closed_loop(self.step, seconds)
        w["attempted"] = w["steps"] * self.points
        w["failed"] = self.failed - f0
        return w

    def work_per_step(self):
        return work.step_work(self.sizes.values(),
                              [(m, c) for m in self.ms for c in self.css],
                              len(self.alphas))

    def release(self) -> None:
        self.ctx.traces = None

    def close(self) -> None:
        pass

    def _sample(self):
        rng = np.random.default_rng([self.ctx.seed, 2])
        n = int(self.ctx.traffic["check"]["points"])
        grid = {"alphas": self.alphas, "ms": self.ms,
                "compute_slots": self.css}
        sizes = {k: v[0] for k, v in self.sizes.items()}
        shape = (len(self.alphas), len(self.ms), len(self.css))
        return check.sample_points(rng, sizes, shape, n), grid

    def check(self, control: bool = False) -> dict:
        """Every step's answers at the sampled points against the
        reference; with ``control``, also the control's reading at the same
        sample and step count (the reference in float32 in the program's
        place) under ``"control"``."""
        pts, grid = self._sample()
        precs = ("float64", "float32") if control else ("float64",)
        largest = max(v[0] for v in self.sizes.values())
        refs = check.reference_values(self.ctx.cfg, self.ctx.seed, pts, grid,
                                      precs, check.workers_for(largest))
        out = check.check_steps(self.steps, pts, refs[0])
        if control:
            out["control"] = check.control_steps(len(self.steps), pts,
                                                 refs[0], refs[1])
        return out
