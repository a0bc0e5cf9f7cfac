"""Arithmetic the metric readers in ``metrics/`` share."""
from __future__ import annotations

from typing import Optional

from . import work

#: K1's kernels as the profiler names them (``csrc/level_step.cu``)
K1_KERNELS = ("segment_kernel", "level_kernel")


def k1_seconds(seg: Optional[dict]) -> Optional[float]:
    """Device seconds of K1's kernels in the traced segment."""
    if not seg or seg.get("busy_s") is None:
        return None
    return sum(v for k, v in seg["by_name"].items()
               if any(p in k for p in K1_KERNELS))


def k1_us_per_level(run) -> Optional[float]:
    """K1's device time over the dependent levels it ran, in us."""
    t = k1_seconds(run.seg)
    levels = run.seg["cnt"]["level_step.levels"] if run.seg else 0
    if not t or not levels:
        return None
    return t / levels * 1e6


def device_idle_pct(run) -> Optional[float]:
    """The share of the traced segment in which no device operation ran."""
    seg = run.seg
    if not seg or not seg.get("busy_s"):
        return None
    return 100.0 * (1.0 - seg["busy_s"] / seg["window_s"])


def per_step(run, counter: str) -> Optional[float]:
    steps = run.win.get("steps")
    if not steps:
        return None
    return run.cnt[counter] / steps


def k1_roofline_pct(run) -> Optional[float]:
    """The least time the card needs for the traced steps' work over K1's
    device time."""
    t = k1_seconds(run.seg)
    if not t or run.work_per_step is None:
        return None
    ops, nbytes = run.work_per_step
    steps = run.seg["win"]["steps"]
    bound = work.roofline_s(ops * steps, nbytes * steps, run.device_name)
    return None if bound is None else 100.0 * bound / t


def device_ms_per_point(run) -> Optional[float]:
    """The device's busy time in the profiled window over the points that
    the window completed, in ms."""
    seg = run.seg
    if not seg or not seg.get("busy_s") or not run.win.get("points"):
        return None
    return 1e3 * seg["busy_s"] / run.win["points"]


def points_per_s(run) -> Optional[float]:
    """Points completed over the window's time on the host's clock."""
    if "points" not in run.win:
        return None
    return run.win["points"] / run.win["elapsed_s"]


def demoted_share_pct(run) -> Optional[float]:
    """Share of the window's sweep columns that the float32 certificate
    sent to the float64 rerun, %."""
    c = run.cnt
    n = c["backend.certified_columns"] + c["backend.demoted_columns"]
    return 100.0 * c["backend.demoted_columns"] / n if n else None


def records_per_step(run) -> Optional[float]:
    """Schedule recordings inside the window per step."""
    return per_step(run, "sched.record_runs")


def levels_per_step(run) -> Optional[float]:
    """Dependent levels K1 ran per step in the window."""
    return per_step(run, "level_step.levels") or None
