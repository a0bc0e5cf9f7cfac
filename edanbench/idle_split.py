"""Put the card's idle time in a traced window down to the program's own
spans (``repro_torch.core.spans``: ``edan.grid``, ``edan.verify``, ...).

``idle_by_span(prof)`` maps each ``edan.`` span name to the seconds of the
traced window in which the card ran no device operation while that span
was the innermost ``edan.`` span open on the host; ``""`` takes the idle
time under no program span (the harness's loop, or the device draining
between steps).  Idle stretches are split at span boundaries, not named
by their middle, so the values sum to ``window_s - busy_s`` of
``devtrace.reduce`` on the same profile: the window and the device
operations are taken as ``reduce`` takes them, and the device-side copies
of the spans (user annotations on the card) are not device operations.

``python3 -m edanbench.idle_split --workload <cell> --seed <n> [<n> ...]``
(with ``src`` on ``PYTHONPATH``) runs the cell traced, as ``--trace 1``
does, once per seed, and prints one JSON line per run: the split, its
shares of the window under the names in ``SHARES``, the spans a step, the
traced window's points per second and the result line's metrics.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from typing import Optional

from . import devtrace, harness

PREFIX = "edan."
#: shares of the traced window, % (100 x seconds / ``window_s``), of the
#: idle time under these innermost spans
SHARES = {
    "device.idle_in_verify.grid": ("edan.verify",),
    "device.idle_in_backend.grid": ("edan.backend.accumulate",),
    "device.idle_unspanned.grid": ("edan.grid", ""),
    "device.idle_in_record.sweep": ("edan.sched.record",
                                    "edan.sched.rerecord"),
}


def _read(prof):
    """(the window, the device operations' intervals, the host ``edan.``
    spans) in ns, with the window and the device operations as
    ``devtrace.reduce`` takes them; None without a window."""
    win, dev, spans = None, [], []
    for t0, t1, name, on_dev, user in devtrace._events(prof):
        if on_dev:
            if not user and not name.startswith("edanbench."):
                dev.append((t0, t1))
        elif name == devtrace.WINDOW:
            win = (t0, t1)
        elif name.startswith(PREFIX):
            spans.append((t0, t1, name))
    return None if win is None else (win, dev, spans)


def _idle(dev, w0: int, w1: int) -> list:
    """The window's stretches with no device operation, in time order."""
    gaps, cur = [], w0
    for a, b in sorted((max(a, w0), min(b, w1)) for a, b in dev):
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((cur, w1))
    return gaps


def _innermost(spans, w0: int, w1: int) -> list:
    """Disjoint ``(start, end, name)`` pieces that tile the window, each
    named by the innermost span open there (the latest opened), ``""``
    where none is."""
    marks = sorted([(t0, 1, -t1, i) for i, (t0, t1, _) in enumerate(spans)]
                   + [(t1, 0, 0, i) for i, (_, t1, _) in enumerate(spans)])
    pieces, cur, open_ = [], w0, []
    for t, starts, _, i in marks:
        t = min(max(t, w0), w1)
        if t > cur:
            pieces.append((cur, t, spans[open_[-1]][2] if open_ else ""))
            cur = t
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
    if w1 > cur:
        pieces.append((cur, w1, spans[open_[-1]][2] if open_ else ""))
    return pieces


def idle_by_span(prof) -> Optional[dict]:
    """``{span name: idle seconds}`` over the traced window, or None when
    the profile holds no window."""
    got = _read(prof)
    if got is None:
        return None
    (w0, w1), dev, spans = got
    gaps, pieces = _idle(dev, w0, w1), _innermost(spans, w0, w1)
    out: dict = {}
    i = j = 0
    while i < len(gaps) and j < len(pieces):
        a = max(gaps[i][0], pieces[j][0])
        b = min(gaps[i][1], pieces[j][1])
        if b > a:
            name = pieces[j][2]
            out[name] = out.get(name, 0) + (b - a)
        if gaps[i][1] <= pieces[j][1]:
            i += 1
        else:
            j += 1
    return {k: v * 1e-9 for k, v in out.items()}


def span_counts(prof) -> Counter:
    """How many of each ``edan.`` span opened inside the window."""
    got = _read(prof)
    if got is None:
        return Counter()
    (w0, w1), _, spans = got
    return Counter(n for t0, _, n in spans if w0 <= t0 < w1)


def idle_share_pct(seg: Optional[dict], names) -> Optional[float]:
    """100 x the idle seconds under ``names`` over the window, or None
    where the segment has no split or no busy time (the CPU cells)."""
    if not seg or not seg.get("busy_s") or seg.get("idle_by_span") is None:
        return None
    return 100.0 * sum(seg["idle_by_span"].get(n, 0.0)
                       for n in names) / seg["window_s"]


def run(cell: str, seed: int, device: str = "cuda",
        root=harness.ROOT) -> dict:
    """One traced run of ``cell`` with the split beside its result."""
    seen = {}
    reduce, traced = devtrace.reduce, harness._traced_window

    def split_reduce(prof):
        red = reduce(prof)
        if red is not None:
            red["idle_by_span"] = idle_by_span(prof)
            red["span_counts"] = span_counts(prof)
        return red

    def keep(*args, **kwargs):
        seen["seg"] = traced(*args, **kwargs)
        return seen["seg"]

    devtrace.reduce, harness._traced_window = split_reduce, keep
    try:
        out = harness.run_cell(cell, seed, harness.TRACE_SECONDS, True,
                               root=root, device=device)
    finally:
        devtrace.reduce, harness._traced_window = reduce, traced
    seg, win = seen["seg"], seen["seg"]["win"]
    line = {"workload": cell, "seed": seed, "correct": out["correct"],
            "steps": win["steps"],
            "traced_points_per_s": win["points"] / win["elapsed_s"],
            "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
    if seg.get("busy_s") is not None:
        split = seg["idle_by_span"]
        line.update(
            window_s=seg["window_s"], busy_s=seg["busy_s"],
            idle_by_span=split,
            split_minus_idle_s=(sum(split.values())
                                - (seg["window_s"] - seg["busy_s"])),
            shares={k: idle_share_pct(seg, v) for k, v in SHARES.items()},
            spans_per_step={k: v / win["steps"]
                            for k, v in seg["span_counts"].items()},
            edan_ops_on_device=sorted(k for k in seg["by_name"]
                                      if k.startswith(PREFIX)),
            idle_gaps=seg["gaps"])
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    for seed in a.seed:
        print(json.dumps(run(a.workload, seed, a.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
