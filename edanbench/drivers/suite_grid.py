"""One client in a closed loop; each step is one
``repro_torch.core.suite.suite_sweep_grid`` over the union of all the
configuration's traces, its members in an order drawn from the seed."""
from __future__ import annotations

from repro_torch.core.suite import EDagSuite, suite_sweep_grid

from ..grid import GridDriver


class Driver(GridDriver):
    def prepare(self) -> None:
        self.suite = EDagSuite([self.ctx.traces[k] for k in self.order],
                               names=self.order)

    def compute(self, alphas=None) -> dict:
        a = self.alphas if alphas is None else alphas
        out = suite_sweep_grid(self.suite, a, ms=self.ms,
                               compute_slots=self.css, unit=self.unit)
        return {k: out[i] for i, k in enumerate(self.order)}

    def release(self) -> None:
        super().release()
        self.suite = None
