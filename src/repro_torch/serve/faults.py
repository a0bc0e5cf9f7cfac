"""Deterministic fault injection for the analysis service.

The robustness claims of ``serve/analysis.py`` — bounded retries recover
transients, a poisoned member never takes its co-batched requests down,
deadlines fail alone, backend failures demote through the ladder — are
only claims until a fault fires.  This module makes faults first-class
and deterministic, with the reference package's stages, kinds, grammar
and errors:

* **Stages** — every service pipeline stage is an injection point
  (``load``, ``trace-model``, ``finalize``, ``schedule``, ``replay``,
  ``placement``, ``report``, ``store``), plus core hook points: ``kernel``
  fires inside the port's level-kernel dispatch (``backend.fault_hook``,
  called before every pass on a tensor on the card), and ``cache-load`` /
  ``cache-store`` fire inside the persistent schedule cache's disk IO.
  Unlike the reference's kernel path, the port's dispatch has no silent
  fallback: a ``kernel`` fault propagates to the service's replay stage,
  which walks the demotion ladder and reports the rung it ended on.

* **Kinds** —
  ``io``       raise ``InjectedIOError`` (an ``OSError``: transient disk
               or trace-store trouble, retryable);
  ``backend``  raise ``InjectedBackendError`` (a ``RuntimeError``: a
               device or compiler failure, retryable and demotable);
  ``latency``  sleep ``delay`` seconds, then continue (deadline tests);
  ``cache``    corrupt the newest compressed schedule-cache entry in
               place (exercises quarantine and re-record), then continue.

* **Determinism** — no randomness.  ``count=N`` fires on the first N
  matching checks (a transient), ``every=K`` on every K-th (a recurring
  fault); with neither it fires on every check (a hard fault).  ``rid=R``
  restricts a spec to one request id and ``min_batch=B`` to checks made
  for a batch of at least B members.

Faults come from ``$EDAN_FAULTS`` (comma-separated clauses
``stage:kind[:param=value]*``, re-parsed whenever its value changes; a
mistyped stage, kind or parameter raises listing the valid choices) and
from ``install(stage, kind, ...)``, undone by ``reset()``, which also
forgets the parsed environment and detaches the core hooks.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..core import backend as _bk
from ..core import schedule_cache as _sc

STAGES = ("load", "trace-model", "finalize", "schedule", "replay",
          "placement", "report", "store", "kernel", "cache-load",
          "cache-store")
KINDS = ("io", "backend", "latency", "cache")
_PARAMS = ("count", "every", "delay", "rid", "min_batch")


class InjectedFault(Exception):
    """Marker mixin: every raising injected fault derives from this."""


class InjectedIOError(InjectedFault, OSError):
    """Injected IO failure (trace store / result store / cache disk)."""


class InjectedBackendError(InjectedFault, RuntimeError):
    """Injected numeric-backend failure (accelerator/compiler trouble)."""


@dataclass
class FaultSpec:
    """One armed fault: where it fires, what it does, on which schedule."""

    stage: str
    kind: str
    count: Optional[int] = None     # fire on the first N matching checks
    every: Optional[int] = None     # fire on every K-th matching check
    delay: float = 0.05             # sleep for kind="latency"
    rid: Optional[int] = None       # restrict to one request id
    min_batch: int = 1              # restrict to batches of >= B members
    calls: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def matches(self, stage: str, rid: Optional[int], batch: int) -> bool:
        if self.stage != stage or batch < self.min_batch:
            return False
        return self.rid is None or (rid is not None and rid == self.rid)

    def should_fire(self) -> bool:
        """Advance the deterministic schedule; True when this check fires."""
        self.calls += 1
        if self.count is not None:
            if self.fired < self.count:
                self.fired += 1
                return True
            return False
        if self.every is not None:
            if self.calls % self.every == 0:
                self.fired += 1
                return True
            return False
        self.fired += 1
        return True                    # neither bound: a hard fault


_programmatic: List[FaultSpec] = []
_env_raw: Optional[str] = None        # last parsed $EDAN_FAULTS value
_env_specs: List[FaultSpec] = []

#: Cumulative fires per (stage, kind), for tests and the bench.
fire_log: dict = {}


def parse_spec(text: str) -> List[FaultSpec]:
    """Parse an ``$EDAN_FAULTS`` spec string into fault specs.

    Grammar: comma-separated clauses ``stage:kind[:param=value]*``.
    Unknown stages, kinds or parameters raise with the valid choices;
    malformed numeric values raise naming the clause."""
    specs: List[FaultSpec] = []
    for clause in text.split(","):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"bad $EDAN_FAULTS clause {clause!r}: expected "
                "stage:kind[:param=value]*")
        stage, kind = parts[0].strip().lower(), parts[1].strip().lower()
        if stage not in STAGES:
            raise ValueError(f"unknown fault stage {stage!r} in "
                             f"$EDAN_FAULTS; pick from {STAGES}")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in "
                             f"$EDAN_FAULTS; pick from {KINDS}")
        kw: dict = {}
        for p in parts[2:]:
            if "=" not in p:
                raise ValueError(f"bad fault parameter {p!r} in "
                                 f"{clause!r}: expected param=value")
            k, v = (s.strip() for s in p.split("=", 1))
            if k not in _PARAMS:
                raise ValueError(f"unknown fault parameter {k!r} in "
                                 f"$EDAN_FAULTS; pick from {_PARAMS}")
            try:
                kw[k] = float(v) if k == "delay" else int(v)
            except ValueError:
                raise ValueError(f"bad value {v!r} for fault parameter "
                                 f"{k!r} in {clause!r}") from None
        specs.append(FaultSpec(stage=stage, kind=kind, **kw))
    return specs


def install(stage: str, kind: str, **kw) -> FaultSpec:
    """Arm one fault programmatically (tests); undone by ``reset()``."""
    if stage not in STAGES:
        raise ValueError(f"unknown fault stage {stage!r}; pick from "
                         f"{STAGES}")
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; pick from "
                         f"{KINDS}")
    bad = set(kw) - set(_PARAMS)
    if bad:
        raise ValueError(f"unknown fault parameters {sorted(bad)}; pick "
                         f"from {_PARAMS}")
    spec = FaultSpec(stage=stage, kind=kind, **kw)
    _programmatic.append(spec)
    _sync_hooks()
    return spec


def reset() -> None:
    """Disarm everything: programmatic specs, the parsed environment memo
    (re-read on the next check) and the core hooks."""
    global _env_raw
    _programmatic.clear()
    _env_specs.clear()
    _env_raw = None
    fire_log.clear()
    _sync_hooks(force_detach=True)


def active() -> List[FaultSpec]:
    """Every armed spec (programmatic + current environment)."""
    _refresh_env()
    return list(_programmatic) + list(_env_specs)


def _refresh_env() -> None:
    """Re-parse ``$EDAN_FAULTS`` when its value changed (monkeypatched
    environments must take effect without an explicit reset)."""
    global _env_raw
    raw = os.environ.get("EDAN_FAULTS", "")
    if raw == _env_raw:
        return
    _env_raw = raw
    _env_specs[:] = parse_spec(raw) if raw.strip() else []
    _sync_hooks()


def _sync_hooks(force_detach: bool = False) -> None:
    """Attach/detach the core hook points to match the armed stages.

    The hooks cost one ``is not None`` test per kernel dispatch / cache
    IO when detached, so they are only attached while a spec targets
    their stage."""
    specs = list(_programmatic) + list(_env_specs)
    stages = {s.stage for s in specs}
    _bk.fault_hook = (_kernel_hook
                      if "kernel" in stages and not force_detach else None)
    _sc.fault_hook = (_cache_hook
                      if ({"cache-load", "cache-store"} & stages
                          and not force_detach) else None)


def _kernel_hook() -> None:
    check("kernel")


def _cache_hook(point: str) -> None:
    check(point)


def _fire(spec: FaultSpec) -> None:
    fire_log[(spec.stage, spec.kind)] = \
        fire_log.get((spec.stage, spec.kind), 0) + 1
    if spec.kind == "io":
        raise InjectedIOError(
            f"injected IO fault at stage {spec.stage!r}")
    if spec.kind == "backend":
        raise InjectedBackendError(
            f"injected backend fault at stage {spec.stage!r}")
    if spec.kind == "latency":
        time.sleep(max(spec.delay, 0.0))
        return
    _corrupt_cache_entry()             # kind == "cache"


def _corrupt_cache_entry() -> None:
    """Overwrite the newest persistent schedule-cache entry with garbage
    (the quarantine-on-load path's trigger).  A no-op when persistence is
    disabled or the cache is empty — the fault layer must never crash
    the host over an unfired corruption."""
    d = _sc.cache_dir()
    if d is None or not d.is_dir():
        return
    try:
        entries = sorted(d.glob("*.npz"), key=lambda p: p.stat().st_mtime)
        if entries:
            entries[-1].write_bytes(b"\x00corrupted by fault injection")
    except OSError:
        pass


def check(stage: str, rid: Optional[int] = None, batch: int = 1) -> None:
    """One instrumented point: fire every armed spec matching ``stage``
    (and the optional request id / batch-size restrictions) whose
    deterministic schedule says it is due.

    Raising kinds raise (``InjectedIOError`` / ``InjectedBackendError``);
    ``latency`` sleeps and returns; ``cache`` corrupts an entry and
    returns.  With nothing armed this is one list lookup."""
    _refresh_env()
    for spec in _programmatic + _env_specs:
        if spec.matches(stage, rid, batch) and spec.should_fire():
            _fire(spec)
