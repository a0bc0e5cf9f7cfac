"""Host spans at the layer boundaries of the sweep path, on the profiler's
clock.

A span is a ``torch.profiler.record_function`` annotation, opened only
while a torch profiler is recording: the profiler being on is the switch.
With none recording, ``span`` costs one flag check and enters nothing.  The
profiler keeps the spans with its other events, so a reader of its trace
can put each stretch of device time, or of device idleness, down to the
innermost span open on the host at that moment.

The names are fixed and start with ``edan.``:

* ``edan.grid``: one public sweep call (``grid_span``; nested sweep calls
  do not open another);
* ``edan.suite.plan``: a union plan build, its member recordings inside;
* ``edan.sched.record`` / ``edan.sched.rerecord``: one schedule recording
  (the heapq event loop and its replay plan); a re-recording is one made
  for the points that the plan in hand did not certify;
* ``edan.replay``: one chunk's fill of the cost matrix and its dispatch;
* ``edan.backend.accumulate``: the dtype policy around the level passes
  (the float32 pre-screen, the certificate and their transfers);
* ``edan.k1``: one level pass (K1 on the card, the plain version on the
  CPU);
* ``edan.verify``: the issue-order check of one chunk and its transfer to
  the host;
* ``edan.suite.fallback``: a union group's per-member fallback.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

#: True while a torch profiler records on this process
_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_tls = threading.local()


def span(name: str):
    """``record_function(name)`` while a profiler records, else a shared
    no-op context."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def _grid():
    _tls.grid = True
    try:
        with torch.profiler.record_function("edan.grid"):
            yield
    finally:
        _tls.grid = False


def grid_span():
    """``edan.grid`` around a public sweep call, unless this thread is
    already inside one."""
    if not _recording() or getattr(_tls, "grid", False):
        return _OFF
    return _grid()
