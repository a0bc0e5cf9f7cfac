"""One client in a closed loop; each step is one
``repro_torch.core.scheduler.sweep_grid`` per trace of the configuration,
in an order drawn from the seed: single traces, outside any union."""
from __future__ import annotations

from repro_torch.core.scheduler import sweep_grid

from ..grid import GridDriver


class Driver(GridDriver):
    def compute(self, alphas=None) -> dict:
        a = self.alphas if alphas is None else alphas
        return {k: sweep_grid(self.ctx.traces[k], a, ms=self.ms,
                              compute_slots=self.css, unit=self.unit)
                for k in self.order}
