"""Fault tolerance harness: resume-from-latest, emergency save on SIGTERM,
failure-injected retry loop, and a straggler watchdog — the reference
package's ``train/fault.py`` over the port's checkpoints.

All state that matters (params, optimizer, data-pipeline cursor, RNG)
lives in the checkpoint, so the control flow is the same at any scale.
Four faults of the reference are not copied (ROADMAP §C):

* its SIGTERM handler reads the current step, which only ``run`` sets: a
  SIGTERM between construction and ``run`` raised ``AttributeError``
  instead of saving.  Here the step is known from construction on;
* it never restored the previous handler: after a loop had finished, a
  SIGTERM still saved that loop's old state, and loops in one process
  chained their handlers.  Here ``run`` puts the previous handler back
  when it returns or raises;
* after the emergency save it called the previous handler only when that
  was a Python function, so under the default disposition a SIGTERM
  never ended the process.  Here the default disposition is restored and
  the signal raised again, so the process ends as it would have;
* after a restore it kept the step count of the failed attempt, so an
  emergency save during the replay labelled the restored state with a
  later step (and a resume would have skipped the steps between).  Here
  the count follows the restored state.
"""
from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from . import checkpoint as ckpt


@dataclass
class StragglerStats:
    """Step-time watchdog: flags steps slower than k*median as stragglers
    (on multi-host: triggers data re-balance / hot-spare swap-in)."""
    window: int = 50
    k: float = 3.0
    times: list = field(default_factory=list)
    flagged: int = 0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = sorted(self.times)[len(self.times) // 2]
        slow = len(self.times) >= 5 and dt > self.k * med
        self.flagged += int(slow)
        return slow


class FaultTolerantLoop:
    """Drives step_fn with checkpoint/restart semantics.

    * restores the latest checkpoint on construction (onto ``device``, or
      each leaf of ``state``'s own device), else saves step 0 there,
    * periodic async checkpoints,
    * emergency synchronous checkpoint on SIGTERM (preemption), from
      construction until ``run`` returns,
    * on a step exception (injected or real): restore latest and replay.
    """

    def __init__(self, state, directory: str, save_every: int = 100,
                 keep: int = 3, device=None,
                 inject_failure: Optional[Callable[[int], bool]] = None):
        self.directory = directory
        self.save_every = save_every
        self.keep = keep
        self.device = device
        self.inject_failure = inject_failure
        self.straggler = StragglerStats()
        self.restarts = 0
        step = ckpt.latest_step(directory)
        if step is not None:
            state, meta = ckpt.restore(state, directory, device=device)
            self.start_step = meta["step"]
        else:
            self.start_step = 0
            # initial checkpoint: a failure before the first periodic save
            # must still be recoverable
            ckpt.save(state, directory, 0, keep=keep)
        self.state = state
        self._cur_step = self.start_step
        self._prev = {}
        self._install_signal_handlers()

    def _install_signal_handlers(self):
        for sig in (signal.SIGTERM,):
            if sig in self._prev:
                continue
            try:
                self._prev[sig] = signal.signal(sig, self._emergency)
            except ValueError:
                pass                      # non-main thread (tests)

    def _restore_signal_handlers(self):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev = {}

    def _emergency(self, signum, frame):
        ckpt.save(self.state, self.directory, self._cur_step,
                  extra={"emergency": True}, keep=self.keep)
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            # the default action (end the process), as without this loop
            self._restore_signal_handlers()
            os.kill(os.getpid(), signum)

    def run(self, step_fn: Callable, n_steps: int):
        """step_fn(state, step)->state.  Returns final state."""
        self._install_signal_handlers()
        try:
            return self._run(step_fn, n_steps)
        finally:
            self._restore_signal_handlers()

    def _run(self, step_fn: Callable, n_steps: int):
        s = self.start_step
        self._cur_step = s
        while s < n_steps:
            t0 = time.time()
            try:
                if self.inject_failure and self.inject_failure(s):
                    raise RuntimeError(f"injected failure at step {s}")
                self.state = step_fn(self.state, s)
            except Exception:
                self.restarts += 1
                ckpt.wait_pending()          # async saves land before restore
                last = ckpt.latest_step(self.directory)
                if last is None:
                    raise
                self.state, meta = ckpt.restore(
                    self.state, self.directory, device=self.device)
                s = meta["step"]
                self._cur_step = s
                continue
            s += 1
            self._cur_step = s
            self.straggler.record(time.time() - t0)
            if self.save_every and s % self.save_every == 0:
                ckpt.save_async(self.state, self.directory, s, keep=self.keep)
        ckpt.wait_pending()
        ckpt.save(self.state, self.directory, s, keep=self.keep)
        return self.state
