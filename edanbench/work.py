"""The work a sweep step needs of K1, the level kernel, and the peaks of
the cards it is held to.

One point is one (max,+) pass over the replay plan of its (trace, m,
compute slots) block: ``rows`` vertices, the trace's ``edges`` and the
``queue`` edges that chain the vertices sharing an issue slot (one per
memory vertex past the first ``m``, and with ``compute_slots`` > 0 one per
ALU vertex past the first ``compute_slots``).  Counted once however the
program runs it:

* operations: one max per edge and one add per row, per point;
* bytes: the plan's structure read once per step (a 4-byte source per
  edge, a 4-byte index per row), and per point each row's float64 base
  cost read once and its float64 finish time written once.

A second chunk, or a float64 rerun of a column the float32 certificate
refused, is time the program spends, not work the answer needs.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

#: Published dense peaks, by ``torch.cuda.get_device_name()``: NVIDIA's
#: H100 SXM data sheet (float64 without the tensor cores; HBM3), at the
#: card's full 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 34.0e12, "bytes_per_s": 3.35e12},
}


def block(rows: int, edges: int, n_mem: int, m: int, compute_slots: int,
          points: int) -> Tuple[float, float]:
    """(operations, bytes) of ``points`` points over one block."""
    queue = max(n_mem - m, 0)
    if compute_slots:
        queue += max(rows - n_mem - compute_slots, 0)
    ops = float(points) * (edges + queue + rows)
    nbytes = 4.0 * (edges + queue + rows) + 16.0 * rows * points
    return ops, nbytes


def step_work(traces: Iterable[Tuple[int, int, int]], pairs, points: int
              ) -> Tuple[float, float]:
    """(operations, bytes) of one step: every trace ``(rows, edges, n_mem)``
    at every ``(m, compute_slots)`` pair, ``points`` alphas each."""
    ops = nbytes = 0.0
    for rows, edges, n_mem in traces:
        for m, cs in pairs:
            o, b = block(rows, edges, n_mem, m, cs, points)
            ops += o
            nbytes += b
    return ops, nbytes


def roofline_s(ops: float, nbytes: float, device: str) -> Optional[float]:
    """The least time the card could take for this work, or None for a
    card outside the table."""
    peak = PEAKS.get(device)
    if peak is None:
        return None
    return max(ops / peak["flops"], nbytes / peak["bytes_per_s"])
