"""Write the reference package's paper-size results for the PyTorch port.

Runs the reference runner's figures (``benchmarks.run``: figs 9-13 and
tables 1-2, the roofline row has no port counterpart) in this process and
keeps, for each, the lines it printed (CSV rows without their timing
column, then the detail lines) and the results its own figure code
returned.  The engine calls inside those figures are wrapped so that their
raw outputs are kept too: every simulated sweep point, every data-movement
curve, T_inf and T_1 of every report.  The aggregates (ranks, Spearman,
bursts) are the reference's own, or plain reductions of its raw outputs
written here; no code of the port is used.

Last, one latency sweep with dirty alphas on the 32 kB HPCG trace
(``DIRTY_SWEEP``), so that a float32 replay must demote columns and rerun
them in float64.

Writes ``src/repro_torch/configs/paper_expected.json``.

Usage: PYTHONPATH=src JAX_PLATFORMS=cpu python tools/paper_expected.py
"""
from __future__ import annotations

import hashlib
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "configs" / "paper_expected.json"

#: the dirty sweep: two alphas exact in float32 (certified columns) and two
#: that are not (demoted columns), HPCG 16^3 x 6 iterations, 32 kB cache
DIRTY_SWEEP = dict(app="hpcg", cache=32 * 1024, m=4, compute_slots=8,
                   alphas=[50.1, 100.0, 200.3, 300.0])


def plain(x):
    """JSON-ready copy: numpy scalars and arrays become Python values."""
    if isinstance(x, dict):
        return {str(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, np.ndarray)):
        return [plain(v) for v in x]
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


def comparable(lines) -> list:
    """CSV rows without their timing column, detail lines as they are."""
    out = []
    for line in lines:
        if not line.strip():
            continue
        if not line.startswith(" "):
            name, _, derived = line.split(",", 2)
            line = f"{name},{derived}"
        out.append(line)
    return out


def record(module, name: str) -> list:
    """Wrap ``module.name`` so every call's result is appended to the
    returned list."""
    fn, calls = getattr(module, name), []

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(out)
        return out
    setattr(module, name, wrapped)
    return calls


def data_movement(t, U, peaks, frac: float) -> dict:
    return dict(T_inf=float(t[-1]), peak_bytes=float(U.max()),
                mean_bytes=float(U.mean()), bursts=int(peaks(U, frac)),
                U_sha256=hashlib.sha256(np.ascontiguousarray(
                    U, dtype=np.float64).tobytes()).hexdigest())


def reference_figures():
    """Run benchmarks.run's figures; returns (lines, results)."""
    from benchmarks import run as bench
    from benchmarks import (fig09_datamovement, fig10_11_lambda, fig12_Lambda,
                            table1_hpcg, table2_lulesh)
    from repro.configs.paper_suite import ANALYSIS
    dm = record(fig09_datamovement, "data_movement_over_time")
    sweeps = record(fig10_11_lambda, "sweep_report")
    reports = {1: record(table1_hpcg, "report"),
               2: record(table2_lulesh, "report")}
    buf = io.StringIO()
    with redirect_stdout(buf):
        lu_U = bench.fig09()
        fig10_11 = bench.fig10_11()
        fig12 = bench.fig12()
        fig13 = bench.fig13()
        table1 = bench.table1()
        table2 = bench.table2()
    lines = comparable(buf.getvalue().splitlines())

    # fig 9: the runner's lu curve, then main()'s lu curve and six app curves
    peaks = fig09_datamovement._peaks
    assert len(dm) == 8 and np.array_equal(dm[0][1], lu_U)
    apps = [(app, cs) for app in ("hpcg", "lulesh")
            for cs in ANALYSIS.cache_sizes]
    fig09 = dict(lu=data_movement(*dm[1], peaks, 0.3),
                 apps=[dict(app=app, cache=cs,
                            **data_movement(*c, peaks, 0.5))
                       for (app, cs), c in zip(apps, dm[2:])])

    # figs 10-11: each kernel's whole sweep beside its row
    assert len(sweeps) == len(fig10_11["rows"])
    for row, rep in zip(fig10_11["rows"], sweeps):
        row.update(simulated=rep["simulated"], t_inf=rep["t_inf"],
                   Lam=rep["Lam"], B_gbs=rep["B_gbs"])

    for i, rows in ((1, table1), (2, table2)):
        assert len(reports[i]) == len(rows)
        for row, r in zip(rows, reports[i]):
            row.update(t_inf=r.t_inf, t1=r.t1)
    results = dict(fig09=fig09, fig10_11=fig10_11, fig12=fig12, fig13=fig13,
                   table1=table1, table2=table2)
    return lines, plain(results)


def dirty_sweep() -> dict:
    from repro.apps import hpcg
    from repro.configs.paper_suite import ANALYSIS, HPCG_ITERS, HPCG_N
    from repro.core import make_cache
    from repro.core.scheduler import latency_sweep
    g, _ = hpcg.trace_cg(n=HPCG_N, iters=HPCG_ITERS, cache=make_cache(
        DIRTY_SWEEP["cache"], ANALYSIS.cache_line, ANALYSIS.cache_ways))
    mk = latency_sweep(g, DIRTY_SWEEP["alphas"], m=DIRTY_SWEEP["m"],
                       compute_slots=DIRTY_SWEEP["compute_slots"])
    return dict(DIRTY_SWEEP, n=HPCG_N, iters=HPCG_ITERS,
                n_vertices=int(g.n_vertices), makespans=plain(mk))


def main() -> None:
    sys.path.insert(0, str(ROOT))
    lines, results = reference_figures()
    OUT.write_text(json.dumps(dict(
        source="benchmarks.run's figures and engine outputs (JAX package, "
               "CPU), recorded by tools/paper_expected.py",
        lines=lines, results=results, dirty_sweep=dirty_sweep()),
        indent=1) + "\n")
    print(f"wrote {OUT} ({len(lines)} lines)")


if __name__ == "__main__":
    main()
