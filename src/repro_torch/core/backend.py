"""Device dispatch for the level-synchronous (max,+) recurrence.

One recurrence powers the whole engine: the batched longest path
``F[v] = base[v] + max(F[u] for u in preds(v))`` evaluated one topological
level at a time over a matrix of cost columns.  The analytic sweeps call
it through ``EDag``; the batched §4 simulator (``scheduler``) calls it over
the *order-augmented* eDAG, where a vertex may carry one extra queue
predecessor (the vertex issued ``m`` slots earlier on the same resource).

The recurrence runs in the hand-written CUDA kernel
``kernels/level_step.py`` (``csrc/level_step.cu``).  Two backends choose
where the tensors live:

* ``cuda`` (the default) — every cost matrix, the level CSR and the finish
  and ready times are tensors on the card, and the kernel runs there.
  Asking for it without a card raises.
* ``cpu`` — the same tensors on the host, through the kernel's plain
  PyTorch version.  The tests use it.

Select with the ``backend=`` argument or ``$EDAN_TORCH_BACKEND``.  There is
no fallback between the two: a kernel or device failure raises.

Replay and sweep matrices (float64) go through ``replay_accumulate``,
which honours the replay dtype policy of the reference package:

* ``float64`` (``EDAN_X64=1`` / ``replay_dtype="float64"``): the exact
  float64 kernel.
* ``float32`` (named by argument or environment): the pass runs in
  float32, then each column is certified against a per-level error bound
  — finish times are nonnegative integer multiples of the column's
  quantum ``q`` (``column_quanta``), so a makespan safely below
  ``2^24 * q`` proves the float32 pass exact.  Columns that fail are
  rerun in float64 on the same device.  float32 is an execution strategy,
  never an answer: returned values are bit-identical to the float64
  kernel.

Where no argument or variable names a dtype (``named_replay_dtype`` is
None), the reference's float32 default runs on the card as the float64
pass alone: a level of the kernel costs a round of dependent gathers and a
barrier whatever its bytes, and on the card the whole float32 dispatch
never beat one float64 pass (see ``replay_accumulate``).

On the ``cpu`` backend the environment's policy knobs are inert (the plain
float64 version runs), but an explicit ``replay_dtype`` argument is
honoured, so the certificate can be exercised without a card.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..kernels.level_step import level_step
from .counters import Stats
from .spans import spanned

_BACKENDS = ("cuda", "cpu")
_REPLAY_DTYPES = ("float32", "float64")

#: Per-process counters of the replay dispatch (``replay_accumulate``):
#: ``chunks`` counts dispatches; ``cuda_chunks`` those whose passes ran on
#: the card (``cuda_f64_chunks`` the subset run under the float64 policy);
#: ``cpu_chunks`` those run by the plain version on the host;
#: ``latency_bound_chunks`` those the card's default (no dtype named) ran
#: as one float64 pass;
#: ``certified_columns`` / ``demoted_columns`` count sweep columns the
#: float32 certificate accepted / that ran the float64 pass under it (the
#: latency-bound dispatches' columns among them).
stats = Stats(chunks=0, cuda_chunks=0, cuda_f64_chunks=0, cpu_chunks=0,
              latency_bound_chunks=0, certified_columns=0,
              demoted_columns=0)

#: Fault-injection hook: when set, called with no arguments at the top of
#: every CUDA dispatch.  An exception it raises propagates to the caller.
fault_hook = None


def reset_stats() -> None:
    """Zero the replay-dispatch counters (tests and benchmarks)."""
    stats.reset()


def select_backend(override: Optional[str] = None) -> str:
    """Pick the backend: explicit argument > ``$EDAN_TORCH_BACKEND`` >
    ``cuda``.

    An unrecognized value raises with the valid choices.  ``cuda`` without
    a usable card raises too: the port never moves to the CPU on its own."""
    env = os.environ.get("EDAN_TORCH_BACKEND", "").strip().lower()
    choice = (override or env or "cuda").strip().lower()
    if choice not in _BACKENDS:
        src = "backend" if override else "$EDAN_TORCH_BACKEND"
        raise ValueError(f"unknown {src} value {choice!r}; pick from "
                         f"{_BACKENDS}")
    if choice == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the cuda backend was selected but torch sees no CUDA device; "
            "pass backend='cpu' or set EDAN_TORCH_BACKEND=cpu to run on "
            "the host")
    return choice


def device_for(backend: Optional[str] = None) -> torch.device:
    """The torch device of the selected backend."""
    return torch.device(select_backend(backend))


_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "no", "off")


def replay_dtype_policy(override: Optional[str] = None) -> str:
    """Resolve the replay dtype policy.

    Precedence: explicit ``replay_dtype`` argument > ``$EDAN_X64`` (truthy
    selects ``float64``) > ``$EDAN_REPLAY_DTYPE`` > ``float32``.
    Unrecognized values, argument or environment, raise with the valid
    choices.  The ``float32`` that nothing names is the reference's
    default; the card runs it as one float64 pass (``replay_accumulate``).
    """
    return named_replay_dtype(override) or "float32"


def named_replay_dtype(override: Optional[str] = None) -> Optional[str]:
    """The replay dtype an argument or variable names, by
    ``replay_dtype_policy``'s precedence, or None where none names one (a
    falsy ``$EDAN_X64`` names none)."""
    if override:
        if override not in _REPLAY_DTYPES:
            raise ValueError(f"unknown replay_dtype {override!r}; pick "
                             f"from {_REPLAY_DTYPES}")
        return override
    x64 = os.environ.get("EDAN_X64", "").strip().lower()
    if x64:
        if x64 in _TRUTHY:
            return "float64"
        if x64 not in _FALSY:
            raise ValueError(f"unknown $EDAN_X64 value {x64!r}; pick from "
                             f"{_TRUTHY + _FALSY}")
    env = os.environ.get("EDAN_REPLAY_DTYPE", "").strip().lower()
    if env:
        if env not in _REPLAY_DTYPES:
            raise ValueError(f"unknown $EDAN_REPLAY_DTYPE value {env!r}; "
                             f"pick from {_REPLAY_DTYPES}")
        return env
    return None


@dataclass
class LevelCSR:
    """Edge partition of a DAG by destination topological level — the
    input structure of the level kernel.

    ``esrc`` holds edge sources sorted by (level(dst), dst); ``run_dst`` /
    ``run_starts`` / ``run_lens`` describe the runs of equal dst inside
    that order; ``run_ptr`` / ``elevel_ptr`` bound the runs / edges per
    level.  ``qpred[v]`` is an optional extra predecessor (slot chain) as
    a row index; vertices without one point at the zero sentinel row ``n``.
    ``qonly_ptr`` / ``qonly_dst`` partition by level the vertices whose
    only predecessor is their queue predecessor.  ``seg_ptr`` holds block
    boundaries of a union graph.

    The fields are host numpy arrays (int32); ``device_arrays`` hands the
    kernel their device copies, made once per device."""

    n: int
    n_levels: int
    esrc: np.ndarray
    run_dst: np.ndarray
    run_starts: np.ndarray
    run_lens: np.ndarray
    run_ptr: np.ndarray
    elevel_ptr: np.ndarray
    run_maxlen: Optional[list] = None
    qpred: Optional[np.ndarray] = None
    qonly_ptr: Optional[np.ndarray] = None
    qonly_dst: Optional[np.ndarray] = None
    seg_ptr: Optional[np.ndarray] = None
    _dev: dict = field(default_factory=dict, repr=False, compare=False)
    _plans: dict = field(default_factory=dict, repr=False, compare=False)

    def level_maxlens(self) -> list:
        if self.run_maxlen is None:
            if len(self.run_lens) and self.n_levels:
                idx = np.minimum(self.run_ptr[:-1], len(self.run_lens) - 1)
                mx = np.maximum.reduceat(self.run_lens, idx)
                mx[np.diff(self.run_ptr) == 0] = 0
                self.run_maxlen = mx.tolist()
            else:
                self.run_maxlen = [0] * self.n_levels
        return self.run_maxlen

    def level_widths(self) -> np.ndarray:
        """Runs plus queue-only vertices of every level (int64)."""
        w = np.diff(self.run_ptr).astype(np.int64)
        if self.qonly_ptr is not None:
            w += np.diff(self.qonly_ptr)
        return w

    def level_plan(self, narrow: int) -> np.ndarray:
        """The level kernel's launch plan: an (n, 4) int32 array of rows
        ``(l0, l1, wide, levels)`` that cover levels ``1..n_levels-1`` in
        order.  A wide row is one level wider than ``narrow`` (``l1 = l0 +
        1``); a narrow row is a maximal stretch of consecutive levels of
        width at most ``narrow``, from its first non-empty level to its
        last (empty levels inside it stay, empty levels outside every row
        go); ``levels`` counts the row's non-empty levels.  Memoized per
        ``narrow`` and slot-chain attachment."""
        hit = self._plans.get(int(narrow))
        if hit is not None and hit[0] is self.qonly_ptr:
            return hit[1]
        w = self.level_widths()[1:self.n_levels]
        lvl = np.arange(1, len(w) + 1, dtype=np.int64)
        wide = w > narrow
        small = (w > 0) & ~wide
        # narrow levels between the same two wide levels share a row
        seg = np.cumsum(wide)[small]
        at = lvl[small]
        first = np.ones(len(seg), dtype=bool)
        first[1:] = seg[1:] != seg[:-1]
        last = np.ones(len(seg), dtype=bool)
        last[:-1] = first[1:]
        counts = np.diff(np.append(np.nonzero(first)[0], len(seg)))
        one = np.ones(int(wide.sum()), dtype=np.int64)
        rows = np.concatenate([
            np.stack([at[first], at[last] + 1, 0 * counts, counts], axis=1),
            np.stack([lvl[wide], lvl[wide] + 1, one, one], axis=1)])
        got = np.ascontiguousarray(
            rows[np.argsort(rows[:, 0], kind="stable")], dtype=np.int32)
        self._plans[int(narrow)] = (self.qonly_ptr, got)
        return got

    def device_arrays(self, device) -> SimpleNamespace:
        """int32 tensors of the partition on ``device`` (the per-level
        pointers among them, which the segment kernel reads, and each
        run's first source and queue predecessor and each queue-only
        vertex's queue predecessor, gathered here so that the kernels read
        them directly) plus contiguous host copies of the per-level
        pointers the kernels' host loop reads.  Memoized per device and
        slot-chain attachment."""
        device = torch.device(device)
        key = (str(device), id(self.qpred), id(self.qonly_dst))
        got = self._dev.get(key)
        if got is not None:
            return got

        def put(a):
            if a is None:
                return None
            return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)

        def host(a):
            return None if a is None else np.ascontiguousarray(a,
                                                               dtype=np.int32)

        qp = self.qpred
        got = SimpleNamespace(
            esrc=put(self.esrc), run_dst=put(self.run_dst),
            run_starts=put(self.run_starts), run_lens=put(self.run_lens),
            qpred=put(qp), qonly_dst=put(self.qonly_dst),
            run_ptr=put(self.run_ptr), qonly_ptr=put(self.qonly_ptr),
            # what a pair reads, gathered by run and by queue-only vertex
            run_src0=put(np.asarray(self.esrc)[self.run_starts]),
            run_qp=None if qp is None else put(qp[self.run_dst]),
            qonly_qp=(None if qp is None or self.qonly_dst is None
                      else put(qp[self.qonly_dst])),
            run_ptr_host=host(self.run_ptr),
            qonly_ptr_host=host(self.qonly_ptr))
        self._dev = {key: got}
        return got


def build_level_partition(src: np.ndarray, dst: np.ndarray,
                          level: np.ndarray, n: int) -> LevelCSR:
    """Partition edges by destination level.  Every output index array is
    int32 (the engine-wide index discipline)."""
    n_levels = int(level.max()) + 1 if n else 0
    if len(dst):
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        elevel = level[dst]
        order = np.lexsort((dst, elevel))
        esrc = src[order]
        edst = dst[order]
        counts = np.bincount(elevel, minlength=n_levels)
        elevel_ptr = np.concatenate(([0], np.cumsum(counts))).astype(np.int32)
        run_mask = np.empty(len(dst), dtype=bool)
        run_mask[0] = True
        np.not_equal(edst[1:], edst[:-1], out=run_mask[1:])
        run_starts = np.nonzero(run_mask)[0].astype(np.int32)
        run_dst = edst[run_starts]
        run_lens = np.diff(np.append(run_starts, len(dst))).astype(np.int32)
        rcounts = np.bincount(level[run_dst], minlength=n_levels)
        run_ptr = np.concatenate(([0], np.cumsum(rcounts))).astype(np.int32)
    else:
        esrc = np.zeros(0, dtype=np.int32)
        elevel_ptr = np.zeros(max(n_levels, 0) + 1, dtype=np.int32)
        run_starts = np.zeros(0, dtype=np.int32)
        run_dst = np.zeros(0, dtype=np.int32)
        run_lens = np.zeros(0, dtype=np.int32)
        run_ptr = np.zeros(max(n_levels, 0) + 1, dtype=np.int32)
    return LevelCSR(n=n, n_levels=n_levels, esrc=esrc, run_dst=run_dst,
                    run_starts=run_starts, run_lens=run_lens, run_ptr=run_ptr,
                    elevel_ptr=elevel_ptr)


def segment_max_rows(F, seg_ptr, empty: float = 0.0) -> torch.Tensor:
    """Per-segment maximum over the leading axis of ``F`` (a tensor, or an
    array taken to the CPU).  ``seg_ptr`` is a (K+1,) nondecreasing
    boundary array; entry ``i`` is ``F[seg_ptr[i]:seg_ptr[i+1]].max(0)``,
    or ``empty`` for zero-length segments.  Rows past ``seg_ptr[-1]``
    belong to no segment.  Returns float64 on ``F``'s device."""
    F = torch.as_tensor(F)
    seg = np.asarray(seg_ptr, dtype=np.int64)
    out = torch.full((len(seg) - 1,) + tuple(F.shape[1:]), float(empty),
                     dtype=torch.float64, device=F.device)
    for i in np.nonzero(np.diff(seg) > 0)[0].tolist():
        out[i] = F[int(seg[i]):int(seg[i + 1])].amax(dim=0)
    return out


def segment_sum_rows(values, seg_ptr) -> torch.Tensor:
    """Per-segment sum over the leading axis (see ``segment_max_rows``).

    Summed on the host in row order (``np.add.reduceat``): a float sum
    depends on its order, and this one must equal the reference's bit for
    bit.  Returns float64 on ``values``' device."""
    values = torch.as_tensor(values)
    v = values.detach().cpu().numpy()
    seg = np.asarray(seg_ptr, dtype=np.int64)
    out = np.zeros((len(seg) - 1,) + v.shape[1:], dtype=np.float64)
    live = np.nonzero(np.diff(seg) > 0)[0]
    if len(live):
        out[live] = np.add.reduceat(v[:seg[-1]], seg[live], axis=0)
    return torch.from_numpy(out).to(values.device)


def levelize(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Topological levels of a DAG whose edges satisfy src < dst:
    ``level[v]`` is the edge count of the longest path ending at ``v``.

    A strict left-fold over edges sorted by destination, O(E) whatever the
    depth (replay graphs reach depth ~W/m); the accumulator is a memoryview
    over a flat int32 buffer and the edges are boxed in bounded chunks."""
    out = np.zeros(n, dtype=np.int32)
    if len(dst):
        src = np.asarray(src)
        dst = np.asarray(dst)
        if len(dst) > 1 and not bool((dst[1:] >= dst[:-1]).all()):
            order = np.argsort(dst, kind="stable")
            src, dst = src[order], dst[order]
        level = memoryview(out)
        chunk = 1 << 16
        for e0 in range(0, len(dst), chunk):
            for s, d in zip(src[e0:e0 + chunk].tolist(),
                            dst[e0:e0 + chunk].tolist()):
                v = level[s] + 1
                if v > level[d]:
                    level[d] = v
    return out


# ------------------------------------------------------------------ dispatch

@spanned("edan.k1")
def _pass(lv: LevelCSR, F: torch.Tensor, clamp: bool,
          R_out: Optional[torch.Tensor]) -> torch.Tensor:
    """One level pass on ``F``'s device: the CUDA kernel for a tensor on
    the card (after the fault hook), the plain version on the CPU."""
    if F.is_cuda and fault_hook is not None:
        fault_hook()
    return level_step(lv, F, clamp=clamp, R_out=R_out)


def _check_device(F: torch.Tensor, backend: Optional[str]) -> None:
    want = select_backend(backend)
    if F.device.type != want:
        raise ValueError(f"the {want} backend was selected but the matrix "
                         f"lies on {F.device}")


def level_accumulate(lv: LevelCSR, F: torch.Tensor, clamp: bool = True,
                     R_out: Optional[torch.Tensor] = None,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Run the batched (max,+) level recurrence in place on ``F``.

    ``F`` is a float32/float64 tensor of shape (n,), (n, k) or — with slot
    chains — (n+1, k) whose last row is the zero sentinel.  It enters
    holding the base costs and leaves holding the finish times
    ``F[v] = base[v] + max(0?, F[u] for u in preds(v))``.  ``R_out``
    (same shape) receives the DAG-predecessor-only maxima (ready times);
    rows of vertices without DAG predecessors are left untouched.  The
    tensor must lie on the selected backend's device.  Returns ``F``."""
    _check_device(F, backend)
    return _pass(lv, F, clamp, R_out)


# ---------------------------------------------- error-bounded replay mode

#: Largest integer count exactly representable in a float32 significand.
_F32_EXACT_MULTIPLES = 2.0 ** 24


def _lsb_quantum(x) -> np.ndarray:
    """Value of the least significant set significand bit of each
    positive finite float64 — the power of two ``q`` with ``x`` an odd
    multiple of ``q``.  Zero / non-finite entries map to 0."""
    x = np.asarray(x, dtype=np.float64)
    frac, exp = np.frexp(x)
    with np.errstate(invalid="ignore"):
        m = np.where(np.isfinite(frac), frac, 0.0) * 2.0 ** 53
    m = m.astype(np.int64)            # exact: a 53-bit significand
    return np.ldexp((m & -m).astype(np.float64), exp - 53)


def column_quanta(alphas, unit: float) -> np.ndarray:
    """Per-column exactness quantum of a replay cost matrix:
    ``q = min(lsb(alpha), lsb(unit))`` — every value the recurrence
    produces from the column is a nonnegative integer multiple of it.
    ``alphas`` may be 1-D (one alpha per column) or 2-D
    ``(k, n_classes)`` (the minimum over each class row)."""
    alphas = np.atleast_1d(np.asarray(alphas, dtype=np.float64))
    q = _lsb_quantum(alphas)
    if q.ndim == 2:
        q = q.min(axis=1) if q.shape[1] else np.zeros(len(q))
    return np.minimum(q, float(_lsb_quantum(float(unit))))


def _f32_thresholds(quanta: np.ndarray, n_levels: int) -> np.ndarray:
    """Per-column certification thresholds: ``2^24 * q`` slackened by the
    per-level error bound, zeroed where certification is impossible (a
    subnormal-range quantum, or a level count past the bound's reach)."""
    slack = 1.0 - (float(n_levels) + 2.0) * 2.0 ** -22
    if slack <= 0.5:                  # ~2M levels: bound no longer tight
        return np.zeros_like(quanta)
    return np.where(quanta >= 2.0 ** -100,
                    _F32_EXACT_MULTIPLES * quanta * slack, 0.0)


def _certified_f32(F32: torch.Tensor, quanta: np.ndarray,
                   n_levels: int) -> np.ndarray:
    """Columns of a float32 level pass that are provably exact: the
    observed ``max|F32|`` strictly below the slackened ``2^24 * q``
    threshold (see the reference package's ``_certified_f32`` for the
    argument).  The reduction runs on ``F32``'s device; only the (k,)
    maxima come to the host."""
    if len(F32):
        M32 = F32.abs().amax(dim=0).to(torch.float64).cpu().numpy()
    else:
        M32 = np.zeros(F32.shape[1])
    thr = _f32_thresholds(quanta, n_levels)
    return np.isfinite(M32) & (M32 < thr)


def _count_pass(F: torch.Tensor) -> None:
    stats.add("cuda_chunks" if F.is_cuda else "cpu_chunks")


@spanned("edan.backend.accumulate")
def replay_accumulate(lv: LevelCSR, F: torch.Tensor, quanta,
                      clamp: bool = False,
                      R_out: Optional[torch.Tensor] = None,
                      backend: Optional[str] = None,
                      replay_dtype: Optional[str] = None) -> torch.Tensor:
    """Run a float64 replay/sweep level pass under the dtype policy.

    ``F`` / ``R_out`` are float64 ``(rows, k)`` tensors on the selected
    backend's device, as for ``level_accumulate``, and always come back
    bit-identical to the float64 pass:

    * float64 policy (``EDAN_X64=1`` / ``replay_dtype="float64"``, or the
      ``cpu`` backend without an explicit ``replay_dtype``): one float64
      pass.
    * the default on ``cuda`` (no argument or variable names a dtype):
      one float64 pass, counted in ``latency_bound_chunks``.
    * float32 policy (named): a pre-screen keeps columns whose bases all
      sit below the threshold (so their float32 cast is lossless), one
      float32 pass over them, the per-column certificate, and a float64
      pass on the same device over every column that was screened off or
      failed.

    ``quanta`` is the per-column quantum from ``column_quanta``.  Counters
    land in ``backend.stats``."""
    if not isinstance(F, torch.Tensor) or F.ndim != 2 or \
            F.dtype != torch.float64:
        raise ValueError("replay_accumulate expects a float64 (rows, k) "
                         "tensor")
    quanta = np.asarray(quanta, dtype=np.float64)
    if quanta.shape != (F.shape[1],):
        raise ValueError("quanta must have one entry per column")
    stats.add("chunks")
    b = select_backend(backend)
    _check_device(F, b)
    # an explicit replay_dtype is validated (and honoured) on every
    # backend; the environment's knobs only steer the card
    pol = (named_replay_dtype(replay_dtype)
           if (b == "cuda" or replay_dtype) else "float64")
    k = F.shape[1]
    if pol != "float32" or k == 0:
        # the float64 policy, and the card's default (nothing names a
        # dtype): K1 is bound by its levels' latency, and the float32
        # dispatch adds a pre-screen, casts, a certificate, copies and two
        # host syncs.  It never beat one float64 pass on an H100
        # (`launch/k1_dtype.py`: 1.08-2.19x on HPCG 16^3 x 6's replay
        # plan, k = 1-9, and 1.50-11.9x on wide, shallow plans of up to
        # 2.9 GB a level within the replay budget, though the float32 pass
        # alone was up to 1.6x faster there), so the default runs float64
        # alone, whatever the shape, its columns counted as demoted.
        _pass(lv, F, clamp, R_out)
        _count_pass(F)
        if F.is_cuda and pol == "float64":
            stats.add("cuda_f64_chunks")
        if pol is None:
            stats.add("latency_bound_chunks")
            stats.add("demoted_columns", k)
        return F
    # error-bounded float32 mode.  The pre-screen is load-bearing: the
    # a-posteriori certificate only detects rounding inside the pass, so
    # the cast of the bases must be lossless, which |base| < thr <= 2^24 q
    # guarantees.  Screened-off columns take the float64 pass.
    thr = _f32_thresholds(quanta, lv.n_levels)
    if len(F):
        base_mag = F.abs().amax(dim=0).cpu().numpy()
    else:
        base_mag = np.zeros(k)
    live_idx = np.flatnonzero(base_mag < thr)
    _count_pass(F)
    if len(live_idx) == 0:
        stats.add("demoted_columns", k)
        return _pass(lv, F, clamp, R_out)
    li = torch.from_numpy(live_idx).to(F.device)
    F32 = F.index_select(1, li).to(torch.float32).contiguous()
    R32 = (R_out.index_select(1, li).to(torch.float32).contiguous()
           if R_out is not None else None)
    _pass(lv, F32, clamp, R32)
    okl = _certified_f32(F32, quanta[live_idx], lv.n_levels)
    n_ok = int(okl.sum())
    stats.add("certified_columns", n_ok)
    if n_ok == 0:
        # nothing certified: F still holds the untouched bases
        stats.add("demoted_columns", k)
        return _pass(lv, F, clamp, R_out)
    ok = np.zeros(k, dtype=bool)
    ok[live_idx[okl]] = True
    ok_idx = torch.from_numpy(np.flatnonzero(ok)).to(F.device)
    okl_idx = torch.from_numpy(np.flatnonzero(okl)).to(F.device)
    # certified columns are exact multiples of q below 2^24 q: the cast
    # back is lossless
    F.index_copy_(1, ok_idx, F32.index_select(1, okl_idx).to(torch.float64))
    if R_out is not None:
        R_out.index_copy_(1, ok_idx,
                          R32.index_select(1, okl_idx).to(torch.float64))
    bad = np.flatnonzero(~ok)
    if len(bad):
        stats.add("demoted_columns", len(bad))
        bi = torch.from_numpy(bad).to(F.device)
        Fb = F.index_select(1, bi).contiguous()
        Rb = (R_out.index_select(1, bi).contiguous() if R_out is not None
              else None)
        _pass(lv, Fb, clamp, Rb)
        F.index_copy_(1, bi, Fb)
        if R_out is not None:
            R_out.index_copy_(1, bi, Rb)
    return F
