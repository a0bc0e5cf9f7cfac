"""One run of one benchmark cell: set-up, the measured window (profiled
with ``--trace 1``, or where one of the cell's end-to-end metrics comes
from the device's trace), the comparison with the plain reference, and
the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name:

* ``BENCHMARK.json``'s cell names its ``config`` (the file its
  ``configs`` entry gives) and its ``traffic`` (``traffic/<name>.json``);
* the configuration's ``tracer`` names ``tracers/<tracer>.py`` (the
  program's tracer) and ``reference/<tracer>.py`` (the reference's);
* the traffic's ``driver`` names ``drivers/<driver>.py``;
* every metric is read by ``metrics/<metric name>.py``, whose ``read(run)``
  returns a number, or None where it finds nothing to read.

Set-up (``setup_s``) runs from the top of ``run.py`` to the end of the warm
step: imports, CUDA start-up and K1's library (built into the checkout's
``build/`` once), the traces built from the seed, their schedules recorded
into a schedule cache in a fresh directory under ``$TMPDIR`` (removed at
the end: nothing recorded outlives a run), and one warm step.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

from .check import LIMITS

ROOT = Path(__file__).resolve().parents[1]
#: seconds of steps (or of requests) that a ``--trace 1`` run profiles in
#: place of the measured window
TRACE_SECONDS = 4.0
#: top-level modules that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(root: Path, spec: dict, name: str):
    """(cell, configuration, traffic) of the cell ``name``."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; pick from "
                         f"{sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = _read_json(root / cfg_entry["file"])
    traffic = _read_json(root / "edanbench" / "traffic"
                         / f"{cell['traffic']}.json")
    return cell, cfg, traffic


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics this cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones (a metric without ``workloads`` goes to
    every cell that reports the metric it moves)."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell])
            and ("workloads" in m or m["moves"] in names)]


def load_metric(root: Path, name: str):
    path = root / "edanbench" / "metrics" / f"{name}.py"
    mod_name = "edanbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counters() -> dict:
    """The program's counters, flattened: K1's launches and levels, the
    replay dispatch, the scheduler (recordings) and the suites."""
    from repro_torch.core import backend, scheduler, suite
    from repro_torch.kernels.level_step import level_step
    out = {"level_step.levels": level_step.levels,
           "level_step.launches": level_step.launches,
           "level_step.calls": level_step.calls}
    for pre, st in (("backend", backend.stats), ("sched", scheduler.stats),
                    ("suite", suite.stats)):
        for k, v in st.snapshot().items():
            out[f"{pre}.{k}"] = v
    return out


def delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in b}


def _program_env(cache_dir: str, backend: str) -> None:
    """The program's knobs as the configuration states them: every
    inherited ``EDAN_*`` setting dropped, the schedule cache in this run's
    own directory, no trace store, and the build caches at fixed paths
    inside the checkout."""
    for k in [k for k in os.environ if k.startswith("EDAN_")]:
        del os.environ[k]
    os.environ["EDAN_SCHEDULE_CACHE"] = cache_dir
    os.environ["EDAN_TRACE_STORE"] = "off"
    os.environ["EDAN_TORCH_BACKEND"] = backend
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def _device_ok(chips: int) -> Optional[str]:
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards, torch sees "
                f"{torch.cuda.device_count()}")
    return None


def closed_loop(step, seconds: float) -> dict:
    """Run ``step()`` back to back until ``seconds`` have passed; the window
    closes at the first step boundary after that.  ``step`` returns the
    points it completed (0 when it raised)."""
    steps = points = 0
    t0 = time.perf_counter()
    while True:
        points += step()
        steps += 1
        el = time.perf_counter() - t0
        if el >= seconds:
            return {"elapsed_s": el, "steps": steps, "points": points}


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             root: Path = ROOT, device: str = "cuda",
             t0: Optional[float] = None, log=sys.stderr,
             control: bool = False) -> dict:
    """One run; returns the result line as a dict (``correct`` and the
    rest), or raises.  ``device="cpu"`` drives the program's CPU path
    without looking for a card (the CPU tests).  ``control`` also reads
    the control at the same sample (``control.py``; the benchmark's own
    runs do not) and puts it under ``"control"``."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = load_spec(root)
    cell, cfg, traffic = cell_files(root, spec, cell_name)
    seed = int(seed) % (1 << 64)
    tmp = tempfile.mkdtemp(prefix="edanbench-schedules-")
    _program_env(tmp, device)
    drv = None
    try:
        import torch
        if device == "cuda":
            torch.zeros(1, device="cuda")
            from repro_torch.kernels.level_step import level_step
            level_step.build()
        tracers = importlib.import_module(
            f"edanbench.tracers.{cfg['tracer']}")
        c0 = counters()
        ts = time.perf_counter()
        traces = tracers.build(cfg, seed)
        setup_trace_s = time.perf_counter() - ts
        print(f"traces: {len(traces)}, "
              f"{sum(g.n_vertices for g in traces.values())} vertices, "
              f"{sum(g.n_edges for g in traces.values())} edges", file=log)
        ctx = SimpleNamespace(cell=cell, cfg=cfg, traffic=traffic, seed=seed,
                              traces=traces, device=device, log=log)
        drv = importlib.import_module(
            f"edanbench.drivers.{traffic['driver']}").Driver(ctx)
        drv.setup()
        if device == "cuda":
            torch.cuda.synchronize()
        c1 = counters()
        setup_s = time.perf_counter() - t0

        if trace:
            seg = _traced_window(drv, device, TRACE_SECONDS)
            win, cnt = seg["win"], seg["cnt"]
        elif any(m["source"] == "device_trace"
                 for m in cell_metrics(spec, cell_name, False)):
            # an end-to-end metric read from the device's trace: the
            # measured window itself runs under the profiler
            seg = _traced_window(drv, device, seconds)
            win, cnt = seg["win"], seg["cnt"]
        else:
            seg = None
            win = drv.window(seconds)
            cnt = delta(c1, counters())
        kind = (torch.cuda.get_device_name(0) if device == "cuda"
                else "cpu")
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        drv.release()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_chk = time.perf_counter()
        chk = drv.check(control)
        print(f"reference check {time.perf_counter() - t_chk:.1f} s, "
              f"{chk['compared']} values compared", file=log)
        run = SimpleNamespace(
            cell=cell, traffic=traffic, setup_s=setup_s,
            setup_trace_s=setup_trace_s,
            setup_record_s=delta(c0, c1)["sched.record_seconds"],
            win=win, cnt=cnt, seg=seg, device_name=kind,
            work_per_step=drv.work_per_step())
        metrics = {}
        for m in cell_metrics(spec, cell_name, trace):
            v = load_metric(root, m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev = {"platform": "gpu" if device == "cuda" else "cpu",
               "kind": kind, "count": int(cell["chips"]),
               "memory_peak_bytes": int(peak)}
        out = {"correct": all(chk[k] <= v for k, v in LIMITS.items()),
               "attempted": int(win["attempted"]),
               # answers that came wrong; those that never came are the
               # window's own failures
               "failed": int(win["failed"] + chk["wrong"] - chk["missed"]),
               "metrics": metrics, "device": dev}
        if trace and seg.get("busy_s") is not None:
            from . import devtrace
            dev["busy_s"] = seg["busy_s"]
            dev["window_s"] = seg["window_s"]
            out["breakdown"] = {"device_ops": devtrace.top_ops(seg["by_name"]),
                                "idle_gaps": seg["gaps"]}
        if control:
            out["control"] = chk["control"]
        out["checks"] = {k: {"value": chk[k], "limit": v}
                         for k, v in LIMITS.items()}
        return out
    finally:
        if drv is not None:
            drv.close()
        written = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                      if f.is_file())
        print(f"schedule cache: {written} bytes written", file=log)
        shutil.rmtree(tmp, ignore_errors=True)


def _traced_window(drv, device: str, seconds: float) -> dict:
    """``seconds`` of the cell's load under ``torch.profiler`` (closing at a
    step boundary, as the measured window does), with the program's
    counters over the same span: a ``--trace 1`` run's window, or the
    measured window of a cell with an end-to-end metric from the device's
    trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from . import devtrace
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    a = counters()
    with profile(activities=acts) as prof:
        with record_function(devtrace.WINDOW):
            win = drv.window(seconds)
            if device == "cuda":
                torch.cuda.synchronize()
    b = counters()
    red = devtrace.reduce(prof) if device == "cuda" else None
    seg = dict(red or {}, cnt=delta(a, b), win=win)
    if not red:
        seg["busy_s"] = None
    return seg


def forbidden_modules() -> list:
    """Top-level names of loaded modules that this process may not hold."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def main(argv=None, t0: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    spec = load_spec(ROOT)
    cell = {c["name"]: c for c in spec["workloads"]}.get(a.workload)
    if cell is None:
        print(f"unknown workload {a.workload!r}", file=sys.stderr)
        return 2
    why = _device_ok(int(cell["chips"]))
    if why:
        print(f"no result: {why}", file=sys.stderr)
        return 3
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t0=t0)
    bad = forbidden_modules()
    if bad:
        print(f"no result: the process loaded {bad}", file=sys.stderr)
        return 4
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out))
    return 0
