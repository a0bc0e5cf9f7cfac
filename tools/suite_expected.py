"""Write the reference package's suite and placement results for the
PyTorch port.

Runs only the JAX package, on the configurations that ``chip_smoke.py``'s
phase "suite" drives through the port:

* (a) ``suite_sweep_grid`` over PolyBench ``PAPER_15`` at N=20 (15 traces,
  554,380 vertices): alphas ``linspace(50, 300, 13)``, ``ms=(2, 4, 8)``,
  ``compute_slots=(0, 8)``, the default policy and budget
  (``benchmarks/perf_core.py``'s acceptance configuration);
* (b) ``suite_t_inf_sweep`` and ``suite_grid_report(simulate_points=True)``
  on the same suite and grid;
* (c) a class-vector grid: each member carries its own
  ``object_class_map`` overlay, and the alpha rows are as wide as the
  largest object count: all 200, all 1, and for j = 0..3 class j at 1 and
  the rest at 200, over the same ``ms`` and ``compute_slots``;
* (d) ``search_placement`` (``benchmarks/perf_placement.py``'s full
  configuration): each ``PAPER_15`` trace at N=20 and HPCG's CG solve at
  n=8, ``alpha_local=1``, ``alpha_remote=200``, budget footprint/2, m=4,
  ``compute_slots=0``; ``method="oracle"`` where the trace has at most
  ``MAX_ORACLE_OBJECTS`` objects (as the benchmark does), and
  ``method="greedy"`` on every trace.

For (a) and (c) it also records how many (member, pair, point) entries the
union schedule did not certify and the per-member ``simulate_batch``
answered (``fallback_points``): a port whose level kernel is wrong on a
union plan answers those points from its member plans, so the count is what
shows the fault.  For (c) also per member (``fallback_points_by_member``:
each member's blocks are certified on their own, so a suite of some
members falls back at the sum of theirs).

Writes ``src/repro_torch/configs/suite_expected.json``.

Usage: PYTHONPATH=src JAX_PLATFORMS=cpu python tools/suite_expected.py
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "configs" / "suite_expected.json"

N = 20
CG_N = 8
GRID = dict(alphas=np.linspace(50.0, 300.0, 13).tolist(), ms=[2, 4, 8],
            compute_slots=[0, 8])
PLACEMENT = dict(alpha_local=1.0, alpha_remote=200.0, m=4,
                 compute_slots=0, budget="footprint // 2")
#: classes held at alpha_local one at a time in the class-vector grid
CLASS_ONE_AT_A_TIME = 4


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


class count_fallbacks:
    """Counts, inside the block, the points that the reference suite's
    per-member ``simulate_batch`` fallback answered (``.points``), and
    per member of ``names`` (``.by_member``; ``members`` the graphs)."""

    def __init__(self, members=(), names=()):
        self.names = {id(g): n for g, n in zip(members, names)}
        self.by_member = dict.fromkeys(names, 0)

    def __enter__(self):
        from repro.core import suite as SU
        self.module, self.orig, self.points = SU, SU.simulate_batch, 0

        def counted(g, alphas, *args, **kw):
            self.points += len(alphas)
            if id(g) in self.names:
                self.by_member[self.names[id(g)]] += len(alphas)
            return self.orig(g, alphas, *args, **kw)

        SU.simulate_batch = counted
        return self

    def __exit__(self, *exc):
        self.module.simulate_batch = self.orig
        return False


def class_rows(width: int) -> np.ndarray:
    """The class-vector grid's alpha rows."""
    rows = [np.full(width, 200.0), np.full(width, 1.0)]
    for j in range(CLASS_ONE_AT_A_TIME):
        r = np.full(width, 200.0)
        r[j] = 1.0
        rows.append(r)
    return np.array(rows)


def placement(name: str, g) -> dict:
    from repro.core.placement import (MAX_ORACLE_OBJECTS, objects_from_edag,
                                      search_placement)
    objects = objects_from_edag(g)
    budget = sum(o.nbytes for o in objects) // 2
    out = dict(name=name, n_vertices=int(g.n_vertices),
               objects=[o.name for o in objects], budget=int(budget))
    methods = (("oracle", "greedy") if len(objects) <= MAX_ORACLE_OBJECTS
               else ("greedy",))
    for method in methods:
        rep = search_placement(
            g, PLACEMENT["alpha_local"], PLACEMENT["alpha_remote"], budget,
            objects=objects, m=PLACEMENT["m"],
            compute_slots=PLACEMENT["compute_slots"], method=method)
        out[method] = plain(dict(
            local=list(rep.local), makespan=rep.makespan,
            all_local=rep.all_local, all_remote=rep.all_remote,
            budgets=rep.budgets, curve=rep.curve,
            curve_local=[list(s) for s in rep.curve_local],
            marginal=rep.marginal, lam=[o.lam for o in rep.objects]))
    return out


def main() -> None:
    from repro.apps import hpcg, polybench
    from repro.core import (EDagSuite, suite_grid_report, suite_sweep_grid,
                            suite_t_inf_sweep)
    from repro.core.placement import object_class_map, objects_from_edag

    t0 = time.perf_counter()
    names = list(polybench.PAPER_15)
    members = [polybench.trace_kernel(nm, N) for nm in names]
    suite = EDagSuite(members, names=names)
    alphas = np.asarray(GRID["alphas"])
    with count_fallbacks() as grid_fb:
        grid = suite_sweep_grid(suite, alphas, ms=GRID["ms"],
                                compute_slots=GRID["compute_slots"])
    t_inf = suite_t_inf_sweep(suite, alphas)
    rep = suite_grid_report(suite, alphas, ms=GRID["ms"],
                            compute_slots=GRID["compute_slots"],
                            simulate_points=True)
    report = {k: plain(v) for k, v in rep.items()}

    n_obj = []
    for g in members:
        objs = objects_from_edag(g)
        n_obj.append(len(objs))
        g.set_mem_classes(object_class_map(g, objs))
    rows = class_rows(max(n_obj))
    cls_suite = EDagSuite(members, names=names)
    with count_fallbacks(members, names) as cls_fb:
        cls_grid = suite_sweep_grid(cls_suite, rows, ms=GRID["ms"],
                                    compute_slots=GRID["compute_slots"])
    for g in members:
        g.set_mem_classes(None)

    places = [placement(nm, polybench.trace_kernel(nm, N)) for nm in names]
    places.append(placement(f"hpcg_cg_n{CG_N}", hpcg.trace_cg(n=CG_N)[0]))
    seconds = time.perf_counter() - t0
    OUT.write_text(json.dumps(dict(
        source="the JAX package on the CPU, recorded by "
               "tools/suite_expected.py",
        N=N, names=names, n_vertices=[int(g.n_vertices) for g in members],
        grid_config=GRID, grid=plain(grid),
        grid_fallback_points=grid_fb.points, t_inf=plain(t_inf),
        report=report,
        class_grid=dict(n_objects=n_obj, rows=plain(rows),
                        grid=plain(cls_grid),
                        fallback_points=cls_fb.points,
                        fallback_points_by_member=cls_fb.by_member),
        placement=dict(config=PLACEMENT, cg_n=CG_N, traces=places)),
        indent=None, separators=(",", ":")) + "\n")
    print(f"wrote {OUT} in {seconds:.1f} s")


if __name__ == "__main__":
    main()
