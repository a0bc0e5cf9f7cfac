"""Fault-tolerant analysis-as-a-service over the eDAG engine.

Clients submit :class:`AnalysisRequest`\\ s — an eDAG (or the name of a
kernel to trace server-side) plus an alpha × m × compute-slots grid — and
get back the Eq 1–4 report for that grid (``core.metrics.grid_report``'s
fields, simulated points included), equal bit for bit to the reference
package's service on the same requests.  The replays run on the level
kernel (K1) on the card.

* **Batched admission** — pending requests with compatible grids (same
  ms, compute_slots, unit, backend, replay dtype) are unioned into one
  :class:`~repro_torch.core.suite.EDagSuite` and analysed in one stacked
  level pass per m via ``suite_grid_report``.  A batch is packed greedily
  (highest priority first) until its replay cells plus its member traces'
  host arrays would exceed ``$EDAN_REPLAY_MEM_BUDGET``; an oversized
  request rides alone.  Per-member tables are bit-identical to solo runs.

* **Deadlines** — every request carries ``deadline_s`` (default
  ``$EDAN_DEADLINE_S``, else 60), checked at every stage boundary and
  before every retry; an expired request fails alone with a ``deadline``
  error.

* **Bounded retries and the demotion ladder** — each stage retries up to
  ``max_retries`` (default ``$EDAN_MAX_RETRIES``, else 2) with exponential
  backoff.  Replay failures also walk ``ExecPolicy.ladder``: the requested
  policy, then float64 on the same device, then ``("cpu", "float64")``.
  The rung a result was answered on (its concrete backend and the replay
  dtype named, None for the card's default) and the failures it took are
  reported per result.  A fault inside the level kernel's dispatch
  (``faults`` stage ``kernel``) reaches this stage, so it is retried and
  demoted visibly.

* **Poison isolation** — a union that keeps failing after the ladder is
  torn down into solo re-runs; a trace whose solo run also fails is
  quarantined by digest and later requests for it fail fast.

* **Fault injection** — every stage calls ``faults.check(...)``.

Failure results carry ``dict(code, stage, message, retries)`` with
``code`` in ``deadline | quarantined | load-error | replay-error |
report-error``.  Result persistence (``results_dir``) is atomic (tempfile
+ ``os.replace``), best-effort, and writes the reference's JSON layout.

``kind="model"`` requests name a model-zoo config and phase, traced
server-side by ``models.tracing.trace_model`` (fault stage
``trace-model``); they then join union batches like any other request.
"""
from __future__ import annotations

import json
import math
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import backend as _bk
from ..core.graph import EDag
from ..core.metrics import grid_report, suite_grid_report
from ..core.plan import REPLAY_BYTES_PER_CELL, ExecPolicy
from ..core.suite import EDagSuite
from . import faults

DEFAULT_DEADLINE_S = 60.0
DEFAULT_MAX_RETRIES = 2


_ERROR_CODES = ("deadline", "quarantined", "load-error", "replay-error",
                "report-error")


def default_deadline_s() -> float:
    """Per-request deadline default: ``$EDAN_DEADLINE_S`` seconds, falling
    back to 60.  Numeric knob, so parsing is tolerant like
    ``$EDAN_REPLAY_MEM_BUDGET``: empty, unparseable or non-positive
    values fall back rather than raise — a stray export must never take
    the service down (explicit ``deadline_s`` arguments stay strict)."""
    try:
        env = float(os.environ.get("EDAN_DEADLINE_S", ""))
    except (TypeError, ValueError):
        return DEFAULT_DEADLINE_S
    return env if env > 0 and math.isfinite(env) else DEFAULT_DEADLINE_S


def default_max_retries() -> int:
    """Per-stage retry budget default: ``$EDAN_MAX_RETRIES``, falling back
    to 2.  Tolerant like :func:`default_deadline_s`; negatives fall back
    (a *zero* is honoured — retries disabled)."""
    try:
        env = int(os.environ.get("EDAN_MAX_RETRIES", ""))
    except (TypeError, ValueError):
        return DEFAULT_MAX_RETRIES
    return env if env >= 0 else DEFAULT_MAX_RETRIES


class DeadlineExceeded(Exception):
    """Raised internally when a request's deadline expires mid-pipeline."""


@dataclass
class AnalysisRequest:
    """One client request: a trace (or a kernel to trace) plus its grid.

    Exactly one of ``trace`` (a finalized-or-not :class:`EDag`) or
    ``kernel`` must be given.  ``kernel`` names a server-side tracer:
    any polybench scalar kernel (``"atax"``, ``"gemm"``, ...) traced at
    problem size ``n``, or ``"cg"`` for the HPCG conjugate-gradient
    solve on an ``n**3`` grid.  ``deadline_s`` / ``max_retries`` of
    ``None`` take the environment defaults at admission time.  Higher
    ``priority`` requests are packed into union batches first.

    ``kind="placement"`` requests a disaggregation placement search
    (:func:`core.placement.search_placement`) instead of a grid report:
    ``alpha_local`` / ``alpha_remote`` give the latency pair,
    ``local_budget`` the local-capacity byte budget, and the first
    entries of ``ms`` / ``compute_slots`` the machine model.  Placement
    requests inherit the full deadline / retry / demotion-ladder / fault
    semantics but always run solo — the search is per-trace by nature,
    so there is no union to poison.

    ``kind="model"`` names a model-zoo ``config`` and ``phase`` (prefill /
    decode / train) to trace server-side through
    ``models.tracing.trace_model`` at ``seq_len`` / ``batch_size``
    (``reduced`` picks the config's smoke-size reduction); the eDAG then
    rides the grid path like an uploaded trace."""

    trace: Optional[EDag] = None
    kernel: Optional[str] = None
    n: int = 6
    config: Optional[str] = None
    phase: str = "prefill"
    seq_len: int = 32
    batch_size: int = 2
    reduced: bool = True
    alphas: Sequence[float] = (200.0,)
    ms: Sequence[int] = (4,)
    compute_slots: Sequence[int] = (0,)
    unit: float = 1.0
    backend: Optional[str] = None
    replay_dtype: Optional[str] = None
    deadline_s: Optional[float] = None
    max_retries: Optional[int] = None
    priority: int = 0
    name: Optional[str] = None
    kind: str = "grid"
    alpha_local: float = 1.0
    alpha_remote: float = 200.0
    local_budget: Optional[int] = None
    local_budgets: Optional[Sequence[int]] = None
    object_sizes: Optional[dict] = None
    placement_method: str = "auto"

    def __post_init__(self):
        n_src = sum(x is not None
                    for x in (self.trace, self.kernel, self.config))
        if n_src != 1:
            raise ValueError(
                "exactly one of trace=, kernel= or config= must be given")
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(f"deadline_s must be positive, got "
                             f"{self.deadline_s!r}")
        if self.max_retries is not None and self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries!r}")
        if self.kind not in ("grid", "placement", "model"):
            raise ValueError(f"kind must be 'grid', 'placement' or "
                             f"'model', got {self.kind!r}")
        if self.kind == "model":
            if self.config is None:
                raise ValueError("model requests need config= (a model-zoo "
                                 "config name)")
            from ..models.tracing import PHASES
            if self.phase not in PHASES:
                raise ValueError(f"phase must be one of {PHASES}, got "
                                 f"{self.phase!r}")
        elif self.config is not None:
            raise ValueError("config= requires kind='model'")
        if self.kind == "placement":
            if self.local_budget is None or self.local_budget < 0:
                raise ValueError(
                    "placement requests need local_budget >= 0 bytes")
            if self.placement_method not in ("auto", "oracle", "greedy"):
                raise ValueError(f"unknown placement_method "
                                 f"{self.placement_method!r}")


@dataclass
class AnalysisResult:
    """Outcome for one request: a report or a structured error, plus how
    hard the service had to work for it."""

    rid: int
    ok: bool
    report: Optional[dict] = None
    error: Optional[dict] = None
    retries: int = 0
    policy: dict = field(default_factory=dict)
    elapsed_s: float = 0.0
    batch_rids: Tuple[int, ...] = ()
    stored: Optional[bool] = None


class _Pending:
    """A submitted request in flight: deadline clock, loaded trace, and
    the ticket the submitter waits on."""

    __slots__ = ("req", "rid", "t0", "deadline_s", "max_retries",
                 "retries", "g", "digest", "event", "result")

    def __init__(self, req: AnalysisRequest, rid: int):
        self.req = req
        self.rid = rid
        self.t0 = time.monotonic()
        self.deadline_s = (req.deadline_s if req.deadline_s is not None
                           else default_deadline_s())
        self.max_retries = (req.max_retries if req.max_retries is not None
                            else default_max_retries())
        self.retries = 0
        self.g: Optional[EDag] = None
        self.digest: Optional[str] = None
        self.event = threading.Event()
        self.result: Optional[AnalysisResult] = None

    def remaining(self) -> float:
        return self.deadline_s - (time.monotonic() - self.t0)

    def check_deadline(self) -> None:
        if self.remaining() <= 0:
            raise DeadlineExceeded(
                f"request {self.rid} exceeded its {self.deadline_s:g}s "
                "deadline")


def _trace_kernel_by_name(name: str, n: int) -> EDag:
    """Server-side tracing registry: polybench scalar kernels by name,
    plus the HPCG CG solve as ``"cg"``.  Unknown names raise listing the
    valid choices — same contract as the mode-knob environment
    variables."""
    from ..apps import polybench
    if name in polybench.SCALAR_KERNELS:
        return polybench.trace_kernel(name, n)
    if name == "cg":
        from ..apps import hpcg
        return hpcg.trace_cg(n=n)[0]
    choices = sorted(polybench.SCALAR_KERNELS) + ["cg"]
    raise ValueError(f"unknown kernel {name!r}; pick from {choices}")


def _error(code: str, stage: str, message: str, retries: int = 0) -> dict:
    assert code in _ERROR_CODES
    return {"code": code, "stage": stage, "message": message,
            "retries": retries}


def _demotion_ladder(backend: Optional[str], replay_dtype: Optional[str],
                     mem_budget: Optional[int] = None):
    """Replay policies in degradation order (``ExecPolicy.ladder``): what
    was asked for, then float64 on the same device (no certificate to
    fail), then ``("cpu", "float64")`` (no card).  Each rung carries the
    service's replay budget."""
    return ExecPolicy.resolve(backend=backend, replay_dtype=replay_dtype,
                              mem_budget=mem_budget).ladder()


def _load_level_kernel() -> None:
    """Build and load the level kernel (K1) when the default backend is
    the card, before the admission thread starts, so the first request's
    deadline does not pay for the compiler.  A build failure raises
    here."""
    try:
        if _bk.select_backend() != "cuda":
            return
    except (ValueError, RuntimeError):
        return                 # no card: the requests' own rungs decide
    from ..kernels.level_step import level_step
    level_step.build()


class AnalysisService:
    """The request engine.  ``submit``/``run`` go through a background
    admission thread that batches compatible pending requests;
    ``process`` runs the same pipeline synchronously on the caller's
    thread (no batching window, deterministic for tests).

    ``batch_window_s`` is how long admission lingers after the first
    pending request to let a batch fill; ``backoff_s`` scales the
    exponential retry backoff (``backoff_s * 2**attempt`` — zero it in
    tests); ``mem_budget`` overrides ``$EDAN_REPLAY_MEM_BUDGET`` for
    batch packing and replay; ``results_dir`` enables atomic best-effort
    JSON persistence of every result."""

    def __init__(self, batch_window_s: float = 0.02,
                 backoff_s: float = 0.05,
                 mem_budget: Optional[int] = None,
                 results_dir=None,
                 start: bool = True):
        self.batch_window_s = float(batch_window_s)
        self.backoff_s = float(backoff_s)
        self.mem_budget = mem_budget
        self.results_dir = Path(results_dir) if results_dir else None
        self._lock = threading.Condition()
        self._queue: List[_Pending] = []
        self._next_rid = 0
        self._closed = False
        self._quarantined: Dict[str, str] = {}
        self._thread: Optional[threading.Thread] = None
        if start:
            _load_level_kernel()
            self._thread = threading.Thread(
                target=self._admission_loop, name="edan-admission",
                daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- client
    def submit(self, req: AnalysisRequest) -> _Pending:
        """Enqueue one request; returns a ticket whose ``event`` is set
        when ``result`` is ready."""
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            p = _Pending(req, self._next_rid)
            self._next_rid += 1
            self._queue.append(p)
            self._lock.notify_all()
        return p

    def run(self, reqs: Sequence[AnalysisRequest],
            timeout: Optional[float] = None) -> List[AnalysisResult]:
        """Submit a batch and wait for every result (submission order)."""
        tickets = [self.submit(r) for r in reqs]
        for t in tickets:
            if not t.event.wait(timeout):
                raise TimeoutError(
                    f"request {t.rid} did not complete within {timeout}s")
        return [t.result for t in tickets]

    def process(self, reqs: Sequence[AnalysisRequest]) -> List[AnalysisResult]:
        """Synchronous inline path: admit and execute ``reqs`` as one
        wave on the calling thread.  Same batching/packing/fault
        semantics as the background loop, none of the timing."""
        with self._lock:
            pend = [_Pending(r, self._next_rid + i)
                    for i, r in enumerate(reqs)]
            self._next_rid += len(reqs)
        self._admit(pend)
        return [p.result for p in pend]

    def close(self) -> None:
        """Stop admission; pending requests are drained first."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    # ---------------------------------------------------------- admission
    def _admission_loop(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._lock.wait()
                if self._closed and not self._queue:
                    return
            time.sleep(self.batch_window_s)     # let a batch accumulate
            with self._lock:
                wave, self._queue = self._queue, []
            if wave:
                self._admit(wave)

    def _admit(self, wave: List[_Pending]) -> None:
        """One admission wave: load every request, group compatible
        survivors, pack each group under the replay memory budget, run
        the batches."""
        loaded: List[_Pending] = []
        for p in wave:
            if self._load(p):
                loaded.append(p)
        groups: Dict[tuple, List[_Pending]] = {}
        for p in loaded:
            r = p.req
            if r.kind == "placement":
                # a placement search is per-trace by nature (the class
                # overlay is the trace's own objects), so it never joins
                # a union batch — it runs solo right here, with the same
                # deadline/retry/ladder semantics
                self._execute_placement(p)
                continue
            key = (tuple(r.ms), tuple(r.compute_slots), float(r.unit),
                   r.backend, r.replay_dtype)
            groups.setdefault(key, []).append(p)
        for members in groups.values():
            for batch in self._pack(members):
                self._execute_batch(batch)

    def _pack(self, members: List[_Pending]) -> List[List[_Pending]]:
        """Greedy highest-priority-first packing under the replay budget:
        a batch's stacked working set is ``sum(n_vertices) * n_pairs *
        n_alphas(union) * bytes-per-cell`` for the replay matrices *plus*
        every member trace's finalized-array footprint
        (``EDag.array_nbytes`` — union construction copies the member
        CSRs, so at million-vertex scale the traces themselves, not the
        replay cells, can dominate the batch's memory).  An oversized
        request rides alone — ``_member_groups`` inside the suite replay
        streams it."""
        members = sorted(members,
                         key=lambda p: (-p.req.priority, p.rid))
        budget = ExecPolicy.resolve(mem_budget=self.mem_budget).mem_budget
        batches: List[List[_Pending]] = []
        cur: List[_Pending] = []
        cur_alphas: set = set()
        cur_rows = 0
        cur_trace_bytes = 0
        for p in members:
            r = p.req
            n_pairs = max(len(r.ms) * len(r.compute_slots), 1)
            rows = p.g.n_vertices * n_pairs
            tb = sum(p.g.array_nbytes().values())
            alphas = cur_alphas | set(float(a) for a in r.alphas)
            cells = (cur_rows + rows) * len(alphas)
            if cur and (cells * REPLAY_BYTES_PER_CELL
                        + cur_trace_bytes + tb) > budget:
                batches.append(cur)
                cur, cur_alphas, cur_rows = [], set(), 0
                cur_trace_bytes = 0
                alphas = set(float(a) for a in r.alphas)
            cur.append(p)
            cur_alphas = alphas
            cur_rows += rows
            cur_trace_bytes += tb
        if cur:
            batches.append(cur)
        return batches

    # ------------------------------------------------------------- stages
    def _retrying(self, p: _Pending, stage: str, fn):
        """Run one stage under ``p``'s deadline with bounded retries and
        exponential backoff.  Returns ``fn()``'s value; raises
        ``DeadlineExceeded`` or the last failure."""
        attempt = 0
        while True:
            p.check_deadline()
            try:
                return fn(attempt)
            except DeadlineExceeded:
                raise
            except Exception:
                if attempt >= p.max_retries:
                    raise
                p.retries += 1
                attempt += 1
                if self.backoff_s > 0:
                    time.sleep(min(self.backoff_s * 2 ** (attempt - 1),
                                   max(p.remaining(), 0.0)))

    def _fail(self, p: _Pending, code: str, stage: str, exc) -> None:
        if isinstance(exc, DeadlineExceeded):
            code = "deadline"
        p.result = AnalysisResult(
            rid=p.rid, ok=False,
            error=_error(code, stage, str(exc), p.retries),
            retries=p.retries,
            elapsed_s=time.monotonic() - p.t0)
        p.event.set()

    def _load(self, p: _Pending) -> bool:
        """Stage 1+2: resolve the trace (client-supplied, server-side
        kernel tracing, or model-zoo tracing) and finalize it.  Failures
        resolve ``p`` alone; returns True when ``p`` may join a batch."""
        r = p.req
        src_stage = "trace-model" if r.kind == "model" else "load"

        def load_fn(attempt):
            faults.check("load", rid=p.rid)
            return r.trace if r.trace is not None \
                else _trace_kernel_by_name(r.kernel, r.n)

        def trace_model_fn(attempt):
            faults.check("trace-model", rid=p.rid)
            from ..models.tracing import trace_model
            return trace_model(r.config, r.phase, seq_len=r.seq_len,
                               batch_size=r.batch_size, reduced=r.reduced)

        def finalize_fn(attempt):
            faults.check("finalize", rid=p.rid)
            p.g._finalize()
            return p.g.trace_digest()

        try:
            p.g = self._retrying(
                p, src_stage,
                trace_model_fn if r.kind == "model" else load_fn)
            p.digest = self._retrying(p, "finalize", finalize_fn)
        except Exception as exc:
            self._fail(p, "load-error", src_stage, exc)
            return False
        if p.digest in self._quarantined:
            self._fail(p, "quarantined", "load", RuntimeError(
                f"trace {p.digest[:12]} is quarantined: "
                f"{self._quarantined[p.digest]}"))
            return False
        return True

    def _execute_batch(self, batch: List[_Pending]) -> None:
        """Stage 3+4: union the batch, run the suite report with the
        demotion ladder; a persistently failing union is torn down into
        solo re-runs so one poisoned member cannot take results away
        from its neighbours."""
        live = []
        for p in batch:
            try:
                p.check_deadline()
            except DeadlineExceeded as exc:
                self._fail(p, "deadline", "schedule", exc)
                continue
            live.append(p)
        if not live:
            return
        rids = tuple(p.rid for p in live)
        r0 = live[0].req
        alphas_u = np.array(
            sorted({float(a) for p in live for a in p.req.alphas}),
            dtype=np.float64)
        try:
            rep, policy, _ = self._run_report(
                live, alphas_u, r0, batch_size=len(live))
        except Exception as exc:
            if len(live) == 1:
                # no neighbours to protect: the retry/ladder budget was
                # the request's own, so this is final
                self._fail_replay(live[0], exc)
            else:
                # union exhausted ladder + retries: isolate members
                for p in live:
                    self._run_solo(p)
            return
        for k, p in enumerate(live):
            self._finish(p, rep, k if len(live) > 1 else None,
                         alphas_u, policy, rids)

    def _run_report(self, live: List[_Pending], alphas: np.ndarray,
                    r0: AnalysisRequest, batch_size: int):
        """One report run (union when ``len(live) > 1``) walking the
        demotion ladder across retries.  The retry budget and deadline
        are the *strictest* member's — a batch must not outlive the
        tightest deadline riding in it."""
        ladder = _demotion_ladder(r0.backend, r0.replay_dtype,
                                  self.mem_budget)
        strict = min(live, key=lambda p: p.remaining())
        budget = max(p.max_retries for p in live)
        failures = 0
        suite = (EDagSuite([p.g for p in live],
                           names=[p.req.name or f"r{p.rid}" for p in live])
                 if len(live) > 1 else None)
        while True:
            for p in live:
                p.check_deadline()
            pol = ladder[min(failures, len(ladder) - 1)]
            try:
                faults.check("schedule", rid=strict.rid, batch=batch_size)
                faults.check("replay", rid=strict.rid, batch=batch_size)
                if suite is not None:
                    rep = suite_grid_report(
                        suite, alphas, ms=tuple(r0.ms),
                        compute_slots=tuple(r0.compute_slots),
                        simulate_points=True, policy=pol)
                else:
                    rep = grid_report(
                        live[0].g, alphas, ms=tuple(r0.ms),
                        compute_slots=tuple(r0.compute_slots),
                        simulate_points=True, policy=pol)
                return rep, {"backend": pol.backend,
                             "replay_dtype": pol.replay_dtype,
                             "demotions": failures}, failures
            except DeadlineExceeded:
                raise
            except Exception:
                if failures >= budget + len(ladder) - 1:
                    raise
                failures += 1
                for p in live:
                    p.retries += 1
                if self.backoff_s > 0:
                    time.sleep(min(self.backoff_s * 2 ** (failures - 1),
                                   max(strict.remaining(), 0.0)))

    def _run_solo(self, p: _Pending) -> None:
        """Isolation path: re-run one member of a failed union alone.  A
        solo failure quarantines the trace digest — the next request for
        it fails fast instead of poisoning another batch."""
        if p.result is not None:
            return
        alphas = np.asarray(
            sorted(float(a) for a in p.req.alphas), dtype=np.float64)
        try:
            rep, policy, _ = self._run_report([p], alphas, p.req,
                                              batch_size=1)
        except Exception as exc:
            self._fail_replay(p, exc)
            return
        self._finish(p, rep, None, alphas, policy, (p.rid,))

    def _execute_placement(self, p: _Pending) -> None:
        """Placement requests: one solo run of
        :func:`core.placement.search_placement` under the request's
        deadline, retry budget and the same demotion ladder as a grid
        replay — the search replays candidate placements through the
        class-vector engine, so it demotes like any other replay.
        Terminal failures quarantine the trace and report through the
        existing ``replay-error`` code: placement adds a fault *stage*,
        not new error vocabulary."""
        from ..core.placement import search_placement
        r = p.req
        ladder = _demotion_ladder(r.backend, r.replay_dtype,
                                  self.mem_budget)
        failures = 0
        while True:
            try:
                p.check_deadline()
                pol = ladder[min(failures, len(ladder) - 1)]
                faults.check("placement", rid=p.rid)
                rep = search_placement(
                    p.g, r.alpha_local, r.alpha_remote, r.local_budget,
                    sizes=r.object_sizes, budgets=r.local_budgets,
                    m=int(r.ms[0]),
                    compute_slots=int(r.compute_slots[0]),
                    unit=float(r.unit), method=r.placement_method,
                    policy=pol)
                policy = {"backend": pol.backend,
                          "replay_dtype": pol.replay_dtype,
                          "demotions": failures}
                break
            except DeadlineExceeded as exc:
                self._fail(p, "deadline", "placement", exc)
                return
            except Exception as exc:
                if failures >= p.max_retries + len(ladder) - 1:
                    if p.digest:
                        self._quarantined.setdefault(
                            p.digest,
                            f"placement search failed after retries and "
                            f"the demotion ladder ({exc!r})")
                    self._fail(p, "replay-error", "placement", exc)
                    return
                failures += 1
                p.retries += 1
                if self.backoff_s > 0:
                    time.sleep(min(self.backoff_s * 2 ** (failures - 1),
                                   max(p.remaining(), 0.0)))
        try:
            report = self._retrying(
                p, "report",
                lambda attempt: self._placement_report(p, rep))
        except Exception as exc:
            self._fail(p, "report-error", "report", exc)
            return
        p.result = AnalysisResult(
            rid=p.rid, ok=True, report=report, retries=p.retries,
            policy=policy, elapsed_s=time.monotonic() - p.t0,
            batch_rids=(p.rid,))
        self._store(p)
        p.event.set()

    def _placement_report(self, p: _Pending, rep) -> dict:
        """Flatten a :class:`~repro.core.placement.PlacementReport` into
        the same JSON-serializable shape ``_store`` writes for grids."""
        faults.check("report", rid=p.rid)
        return {
            "name": p.req.name or (p.req.kernel or f"r{p.rid}"),
            "kind": "placement",
            "method": rep.method,
            "alpha_local": rep.alpha_local,
            "alpha_remote": rep.alpha_remote,
            "m": rep.m, "compute_slots": rep.compute_slots,
            "unit": rep.unit,
            "budget": rep.budget,
            "local": list(rep.local),
            "makespan": rep.makespan,
            "all_local": rep.all_local,
            "all_remote": rep.all_remote,
            "budgets": np.asarray(rep.budgets),
            "curve": np.asarray(rep.curve),
            "curve_local": [list(t) for t in rep.curve_local],
            "marginal": dict(rep.marginal),
            "objects": [dict(name=o.name, nbytes=int(o.nbytes),
                             traffic=int(o.traffic), lam=float(o.lam),
                             n_accesses=o.n_accesses)
                        for o in rep.objects],
        }

    def _fail_replay(self, p: _Pending, exc) -> None:
        """Terminal replay failure: quarantine the trace (unless the
        failure was the deadline — a slow trace is not a poisoned one)
        and resolve the request with a structured error."""
        if not isinstance(exc, DeadlineExceeded) and p.digest:
            self._quarantined.setdefault(
                p.digest, f"replay failed after retries and the "
                          f"demotion ladder ({exc!r})")
        self._fail(p, "replay-error", "replay", exc)

    def _finish(self, p: _Pending, rep: dict, k: Optional[int],
                alphas_u: np.ndarray, policy: dict,
                batch_rids: Tuple[int, ...]) -> None:
        """Stage 5+6: slice this request's alphas out of the (possibly
        union) report, then persist best-effort."""
        try:
            report = self._retrying(
                p, "report",
                lambda attempt: self._slice_report(p, rep, k, alphas_u))
        except Exception as exc:
            self._fail(p, "report-error", "report", exc)
            return
        p.result = AnalysisResult(
            rid=p.rid, ok=True, report=report, retries=p.retries,
            policy=policy, elapsed_s=time.monotonic() - p.t0,
            batch_rids=batch_rids)
        self._store(p)
        p.event.set()

    def _slice_report(self, p: _Pending, rep: dict, k: Optional[int],
                      alphas_u: np.ndarray) -> dict:
        faults.check("report", rid=p.rid)
        req_alphas = np.asarray(
            sorted(float(a) for a in p.req.alphas), dtype=np.float64)
        idx = np.searchsorted(alphas_u, req_alphas)

        def pick(key):
            v = rep[key]
            return v[k] if k is not None else v

        r = p.req
        auto = (f"{r.config}:{r.phase}" if r.config is not None
                else r.kernel) or f"r{p.rid}"
        out = {
            "name": r.name or auto,
            "alphas": req_alphas,
            "ms": np.asarray(rep["ms"]),
            "compute_slots": np.asarray(rep["compute_slots"]),
            "W": float(pick("W")), "D": float(pick("D")),
            "C": float(pick("C")),
            "lam": np.asarray(pick("lam")),
            "t_inf": np.asarray(pick("t_inf"))[idx],
            "t_lower": np.asarray(pick("t_lower"))[idx],
            "t_upper": np.asarray(pick("t_upper"))[idx],
            "Lam": np.asarray(pick("Lam"))[idx],
        }
        if "simulated" in rep:
            out["simulated"] = np.asarray(pick("simulated"))[idx]
        return out

    def _store(self, p: _Pending) -> None:
        """Best-effort atomic persistence: tempfile + ``os.replace`` in
        ``results_dir`` so a crash mid-write leaves either nothing or a
        complete, parseable result — never a torn file.  Persistent
        failure degrades to ``stored=False``; it never fails the
        request."""
        if self.results_dir is None:
            return

        def store_fn(attempt):
            faults.check("store", rid=p.rid)
            self.results_dir.mkdir(parents=True, exist_ok=True)
            doc = {
                "rid": p.rid, "ok": True, "retries": p.retries,
                "policy": p.result.policy,
                "batch_rids": list(p.result.batch_rids),
                "report": {kk: (vv.tolist()
                                if isinstance(vv, np.ndarray) else vv)
                           for kk, vv in p.result.report.items()},
            }
            fd, tmp = tempfile.mkstemp(
                dir=self.results_dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(json.dumps(doc))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.results_dir / f"result_{p.rid}.json")
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            return True

        try:
            p.result.stored = self._retrying(p, "store", store_fn)
        except Exception:
            p.result.stored = False
