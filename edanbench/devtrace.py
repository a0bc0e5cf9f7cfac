"""Reduce a ``torch.profiler`` run to what the per-layer metrics read.

Device operations are the profiler's CUDA events (kernels, copies, sets),
not the device-side copies of host annotations.
The traced window is the span of the harness's own ``edanbench.window``
annotation.  Busy time is the union of the device operations' intervals
inside it; an idle gap is a stretch of it with none, named by the
innermost host event that covers the gap's middle.
"""
from __future__ import annotations

import bisect
from typing import Optional

WINDOW = "edanbench.window"


def _events(prof):
    """``(start_ns, end_ns, name, on_device, user_annotation)`` of every
    raw profiler event (the raw events, not the slower parsed tree)."""
    for e in prof.profiler.kineto_results.events():
        dev = "CUDA" in str(e.device_type()).upper()
        user = bool(getattr(e, "is_user_annotation", lambda: False)())
        t0 = e.start_ns()
        yield t0, t0 + e.duration_ns(), e.name(), dev, user


def reduce(prof) -> Optional[dict]:
    """``dict(window_s, busy_s, by_name, gaps)`` in seconds, or None when
    the profile holds no window annotation.  ``by_name`` maps each device
    operation's name to its total time; ``gaps`` lists the ten longest idle
    gaps as ``[host event, seconds]``."""
    dev, host, win = [], [], None
    for t0, t1, name, on_dev, user in _events(prof):
        if on_dev:
            if not user and not name.startswith("edanbench."):
                dev.append((t0, t1, name))
        elif name == WINDOW:
            win = (t0, t1)
        else:
            host.append((t0, t1, name))
    if win is None:
        return None
    w0, w1 = win
    by_name: dict = {}
    spans = []
    for t0, t1, name in dev:
        a, b = max(t0, w0), min(t1, w1)
        if b > a:
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
            spans.append((a, b))
    spans.sort()
    busy = 0.0
    gaps = []
    cur = w0
    for a, b in spans:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if w1 > cur:
        gaps.append((cur, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for g0, g1 in gaps[:10]:
        mid = 0.5 * (g0 + g1)
        best = None
        for t0, t1, name in host[:bisect.bisect_right(starts, mid)]:
            if t1 >= mid and (best is None or t1 - t0 < best[0]):
                best = (t1 - t0, name)
        named.append([best[1] if best else "host, no profiled event",
                      (g1 - g0) * 1e-9])
    return dict(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                by_name=by_name, gaps=named)


def top_ops(by_name: dict, n: int = 10) -> list:
    """The ``n`` device operations that took most time, as
    ``[name, seconds]``."""
    return [[k[:160], v] for k, v in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]
