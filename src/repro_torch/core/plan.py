"""The plan layer: one normalized sweep query + one resolved execution policy.

Every sweep/report entry point answers the same shape of question —
evaluate these alpha points (scalar latencies or latency-class vectors)
over these (m, compute_slots) machine configurations at this ALU unit cost
— under the same execution knobs: which backend holds the tensors, which
replay dtype policy governs the card, how many bytes one replay chunk may
hold, and whether recorded schedules are reused.

* ``SweepSpec`` captures the query: alphas converted and validated once,
  deduped and sorted once (with the inverse permutation kept so results
  come back in caller order), the machine axes as int tuples, and the
  degenerate-model screen.
* ``ExecPolicy`` captures the execution environment, resolved once at the
  public entry point and carried through the engine as one frozen object.
  Its ``accumulate`` method is the only call site of
  ``backend.replay_accumulate``.

``$EDAN_REPLAY_MEM_BUDGET`` is resolved eagerly and tolerantly (garbage
falls back to the default); the mode knobs ``backend`` / ``replay_dtype``
are carried unresolved and validated at kernel dispatch, so a typo raises
with the valid choices.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import backend as _bk

# Point-chunk memory budget for the batched replay: one pass holds ~3
# (n_vertices, chunk) float64 matrices (base/finish, ready times, scratch)
# plus the float32 copies of the live columns under the float32 policy,
# so chunk ~ budget / (REPLAY_BYTES_PER_CELL * n).
REPLAY_MEM_BUDGET = 512 * 1024 * 1024
REPLAY_BYTES_PER_CELL = 32


def replay_mem_budget(override: Optional[int] = None) -> int:
    """Replay working-set budget in bytes: arg > $EDAN_REPLAY_MEM_BUDGET >
    default.  Environment values that are empty, unparseable or
    non-positive fall back to the default; an explicit argument stays
    strict."""
    if override is not None:
        return max(int(override), 1)
    try:
        env = int(os.environ.get("EDAN_REPLAY_MEM_BUDGET", ""))
    except (TypeError, ValueError):
        return REPLAY_MEM_BUDGET
    return env if env > 0 else REPLAY_MEM_BUDGET


@dataclass(frozen=True)
class ExecPolicy:
    """Resolved execution policy for one engine invocation (or many).

    ``backend`` / ``replay_dtype`` are the requested mode knobs (None =
    environment / default), validated at kernel dispatch; ``mem_budget``
    is the resolved chunk budget in bytes; ``use_cache`` gates schedule
    reuse."""

    backend: Optional[str] = None
    replay_dtype: Optional[str] = None
    mem_budget: int = REPLAY_MEM_BUDGET
    use_cache: bool = True

    @classmethod
    def resolve(cls, backend: Optional[str] = None,
                replay_dtype: Optional[str] = None,
                mem_budget: Optional[int] = None,
                use_cache: bool = True,
                policy: Optional["ExecPolicy"] = None) -> "ExecPolicy":
        """Fold keyword arguments + environment into one policy; a
        pre-resolved ``policy=`` wins outright."""
        if policy is not None:
            return policy
        return cls(backend=backend, replay_dtype=replay_dtype,
                   mem_budget=replay_mem_budget(mem_budget),
                   use_cache=bool(use_cache))

    def device(self) -> torch.device:
        """The device every tensor of this policy's passes lives on."""
        return _bk.device_for(self.backend)

    # ---------------------------------------------------- kernel dispatch

    def accumulate(self, lv, F: torch.Tensor, quanta,
                   clamp: bool = False,
                   R_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One stacked (max,+) pass under this policy — the single site
        that unpacks the policy into ``backend.replay_accumulate``."""
        return _bk.replay_accumulate(lv, F, quanta, clamp=clamp,
                                     R_out=R_out, backend=self.backend,
                                     replay_dtype=self.replay_dtype)

    # -------------------------------------------------- budget accounting

    def points_chunk(self, n: int, k: int) -> int:
        """Balanced point chunk under the replay memory budget (floor of a
        single point)."""
        cap = max(1, int(self.mem_budget //
                         max(REPLAY_BYTES_PER_CELL * n, 1)))
        n_chunks = -(-k // cap)
        return -(-k // n_chunks)

    def cap_rows(self, k: int) -> int:
        """Largest plan row count for which a full-width (rows, k) replay
        chunk fits the budget: the suite's grouping rule shares this
        divisor with ``points_chunk``, so grouping and chunking agree."""
        return max(self.mem_budget // max(REPLAY_BYTES_PER_CELL * k, 1), 1)

    # ---------------------------------------------------- degraded modes

    def ladder(self) -> Tuple["ExecPolicy", ...]:
        """Execution rungs for degraded-mode retries, most capable first:
        the policy as requested, then float64 on the requested policy's own
        device (no float32 certificate to fail), then ``("cpu",
        "float64")`` (no card at all).  Each rung is resolved to its
        concrete backend and the replay dtype an argument or variable
        names before equal rungs are dropped, so a ``cpu`` request has one
        or two rungs and never a device rung.  Where nothing names a dtype
        on the card, rung 0's stays None: the dispatch's default, one
        float64 pass.  A knob that does not resolve (a typo, or ``cuda``
        without a card) is kept as given and raises again at dispatch, on
        its rung.  Budget and cache policy carry through unchanged."""
        try:
            backend = _bk.select_backend(self.backend)
        except (ValueError, RuntimeError):
            backend = self.backend
        try:
            dtype = ("float64" if backend == "cpu" and not self.replay_dtype
                     else _bk.named_replay_dtype(self.replay_dtype))
        except ValueError:
            dtype = self.replay_dtype
        kw = dict(mem_budget=self.mem_budget, use_cache=self.use_cache)
        rungs = (ExecPolicy(backend, dtype, **kw),
                 ExecPolicy(backend, "float64", **kw),
                 ExecPolicy("cpu", "float64", **kw))
        out: list = []
        for r in rungs:
            if r not in out:
                out.append(r)
        return tuple(out)


@dataclass(frozen=True, eq=False)
class SweepSpec:
    """One normalized sweep query: what to evaluate, independent of how.

    ``alphas`` is the caller's point axis as float64 — 1-D scalar latencies
    or a 2-D ``(P, n_classes)`` matrix (``class_mode``).  ``uniq`` is the
    sorted, deduplicated axis the batched engines evaluate and ``inv`` the
    scatter index that restores caller order (None when already sorted and
    unique).  ``bad_costs`` records the degenerate screen (non-positive or
    non-finite alphas or unit); a degenerate query is never deduped."""

    alphas: np.ndarray
    uniq: np.ndarray
    inv: Optional[np.ndarray]
    ms: Tuple[int, ...]
    css: Tuple[int, ...]
    unit: float
    class_mode: bool
    bad_costs: bool

    @classmethod
    def make(cls, alphas, ms=(4,), compute_slots=(0,),
             unit: float = 1.0) -> "SweepSpec":
        """Normalize and validate a sweep query once; rank > 2 raises."""
        a = np.asarray(list(np.atleast_1d(alphas)), dtype=np.float64)
        if a.ndim > 2:
            raise ValueError(
                f"alphas must be 1-D (scalar latencies) or 2-D "
                f"(latency-class vectors); got ndim={a.ndim}")
        ms_t = tuple(int(v) for v in np.atleast_1d(ms))
        css_t = tuple(int(v) for v in np.atleast_1d(compute_slots))
        unit = float(unit)
        class_mode = a.ndim == 2
        bad = (unit <= 0 or not np.isfinite(unit) or
               (len(a) > 0 and bool((a <= 0).any() or
                                    not np.isfinite(a).all())))
        uniq: np.ndarray = a
        inv: Optional[np.ndarray] = None
        if not bad and len(a):
            if class_mode:
                u, iv = np.unique(a, axis=0, return_inverse=True)
                iv = np.asarray(iv).reshape(-1)
            else:
                u, iv = np.unique(a, return_inverse=True)
            if len(u) != len(a) or not np.array_equal(u, a):
                uniq, inv = u, iv
        return cls(alphas=a, uniq=uniq, inv=inv, ms=ms_t, css=css_t,
                   unit=unit, class_mode=class_mode, bad_costs=bad)

    @property
    def n_points(self) -> int:
        return len(self.alphas)

    @property
    def n_uniq(self) -> int:
        """Points the batched engines evaluate (after dedupe)."""
        return len(self.uniq)

    @property
    def n_classes(self) -> Optional[int]:
        """Latency-class count (class mode), else None."""
        return int(self.alphas.shape[1]) if self.class_mode else None

    @property
    def pairs(self) -> list:
        """The (m, compute_slots) machine grid, row-major like the output
        axes of ``sweep_grid``."""
        return [(m, cs) for m in self.ms for cs in self.css]

    def degenerate(self, m: int) -> bool:
        """Whether configuration ``m`` must take the reference loop."""
        return m < 1 or self.bad_costs

    def restore(self, values: np.ndarray, axis: int = 0) -> np.ndarray:
        """Scatter uniq-axis results back to caller order."""
        if self.inv is None:
            return values
        return np.take(values, self.inv, axis=axis)
