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

import math
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
        step = self._latest()
        if step is not None:
            state, meta = self._restore(state)
            self.start_step = meta["step"]
        else:
            self.start_step = 0
            # initial checkpoint: a failure before the first periodic save
            # must still be recoverable
            self._save(state, 0)
        self.state = state
        self._cur_step = self.start_step
        self._prev = {}
        self._install_signal_handlers()

    # the checkpoint's reads and writes, which ``ShardedLoop`` replaces
    def _latest(self):
        return ckpt.latest_step(self.directory)

    def _restore(self, state):
        return ckpt.restore(state, self.directory, device=self.device)

    def _save(self, state, step: int, background: bool = False,
              extra=None):
        if background:
            ckpt.save_async(state, self.directory, step, keep=self.keep)
        else:
            ckpt.save(state, self.directory, step, extra=extra,
                      keep=self.keep)

    def _settle(self):
        """Let pending background saves land."""
        ckpt.wait_pending()

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
        self._save(self.state, self._cur_step, extra={"emergency": True})
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
                self._settle()               # async saves land before restore
                last = self._latest()
                if last is None:
                    raise
                self.state, meta = self._restore(self.state)
                s = meta["step"]
                self._cur_step = s
                continue
            s += 1
            self._cur_step = s
            self.straggler.record(time.time() - t0)
            if self.save_every and s % self.save_every == 0:
                self._save(self.state, s, background=True)
        self._settle()
        self._save(self.state, s)
        return self.state


class ShardedLoop(FaultTolerantLoop):
    """``FaultTolerantLoop`` over the ranks of a ``launch.mesh.RankMesh``
    whose state is each rank's shards, laid out by ``specs`` (a tree
    parallel to the state with a ``PartitionSpec`` at each leaf, as
    ``train_loop.shardings_for_train`` gives them).

    A checkpoint holds the full tree, the files a single-rank run writes:
    every rank writes its blocks into them (``checkpoint.save_blocks``; a
    block replicated over ranks by the first of them), so the ranks must
    share the checkpoint directory's file system, as ranks on one host
    do.  A restore reads each rank's blocks of it (``checkpoint.restore``
    with ``blocks``), so a checkpoint from any mesh, or from one rank,
    resumes on any other.  Saves are synchronous.  Every rank must fail at
    the same step (an injected failure does): a failure on one rank alone
    leaves the others waiting in a collective.  No SIGTERM handler is
    installed: an emergency save needs every rank, which a signal handler
    cannot wait for."""

    def __init__(self, state, directory: str, *, specs, mesh, **kw):
        self.specs, self.mesh = specs, mesh
        super().__init__(state, directory, **kw)

    def _barrier(self):
        import torch.distributed as dist
        dist.barrier(group=self.mesh.group(self.mesh.axis_names)[0])

    def _layout(self, state) -> dict:
        """{key: (full shape, this rank's slices, whether it writes)}."""
        from . import train_loop
        from ..sharding.rules import named_sharding, spec_axes
        mesh = self.mesh

        def one(x, spec):
            axes = spec_axes(spec, x.ndim)
            shape = tuple(n * math.prod(mesh.shape[a] for a in ax)
                          for n, ax in zip(x.shape, axes))
            named = {a for ax in axes for a in ax}
            first = not any(mesh.coords[a] for a in mesh.axis_names
                            if a not in named)
            return _Index((shape, named_sharding(mesh, spec).index(shape),
                           first))
        return {k: b.slices for k, b in ckpt._flatten(
            train_loop._map_specs(one, state, self.specs)).items()}

    def _latest(self):
        self._barrier()
        return ckpt.latest_step(self.directory)

    def _restore(self, state):
        self._barrier()
        out = ckpt.restore(state, self.directory, device=self.device,
                           blocks={k: v[1] for k, v in
                                   self._layout(state).items()})
        self._barrier()
        return out

    def _save(self, state, step: int, background: bool = False,
              extra=None):
        lay = self._layout(state)
        ckpt.save_blocks(ckpt._flatten(state), self.directory, step,
                         shapes={k: v[0] for k, v in lay.items()},
                         indices={k: v[1] for k, v in lay.items()},
                         write={k: v[2] for k, v in lay.items()},
                         lead=self.mesh.rank == 0, barrier=self._barrier,
                         extra=extra, keep=self.keep)

    def _settle(self):
        self._barrier()

    def _install_signal_handlers(self):
        pass


class _Index:
    """A leaf's layout, kept whole through ``checkpoint._flatten``."""

    def __init__(self, slices):
        self.slices = slices
