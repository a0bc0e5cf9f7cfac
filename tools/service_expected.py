"""Write the reference package's service and persistence results for the
PyTorch port.

Runs only the JAX package, on the CPU, on the configurations that
``chip_smoke.py``'s phases "persist" and "service" drive through the port:

* service (``benchmarks/perf_service.py``'s full sizes): 16 waves of 6
  requests over atax, bicg, mvt and gesummv at N=12, alphas (60, 120,
  240), ms (2, 4), deadline 300 s, default backend, each wave through
  ``AnalysisService.process`` on one service:
  - the clean stream: each kernel's report, and per request its ok flag,
    retries, demotions and batch size;
  - the transient stream under ``TRANSIENT_SPEC``: the same per request;
  - the poisoned wave (3 requests; the union always fails, rid 1 fails
    solo too): per request ok flag and error code;
  - a cache fault (``cache-load:cache:count=1``) on one atax request with
    a warm cache directory and no size floor: the schedule cache's
    counters;
* persist, gemm (``benchmarks/perf_core.py::bench_schedule_cache``'s
  full configuration): ``sweep_grid`` at N=20, 26 alphas in [50, 300],
  ms (2, 4, 8), compute slots (0, 8);
* persist, HPCG (``benchmarks/perf_scale.py``'s "1m" tier): CG at n=13, 7
  iterations (~1.09M vertices), alphas (50, 150, 300), m=4, no ALU slots,
  under a 64 MiB replay budget; and the "100k" tier (n=8, 3 iterations)
  through the legacy list build: digest, edge and level counts, and its
  sweep row.

Writes ``src/repro_torch/configs/service_expected.json``.  The schedule
cache and the trace store point at a temporary directory for the run.

Usage: PYTHONPATH=src JAX_PLATFORMS=cpu python tools/service_expected.py
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "configs" / "service_expected.json"

SERVICE = dict(kernels=["atax", "bicg", "mvt", "gesummv"], n_waves=16,
               wave=6, N=12, alphas=[60.0, 120.0, 240.0], ms=[2, 4],
               compute_slots=[0], deadline_s=300.0, backoff_s=0.001,
               transient_spec=("load:io:every=5,replay:backend:every=4,"
                               "store:io:every=3,"
                               "replay:latency:every=7:delay=0.005"),
               poisoned_wave=3, cache_fault_kernel="atax")
GEMM = dict(kernel="gemm", N=20, alphas=np.linspace(50.0, 300.0,
                                                    26).tolist(),
            ms=[2, 4, 8], compute_slots=[0, 8])
HPCG = dict(n=13, iters=7, alphas=[50.0, 150.0, 300.0], ms=[4],
            compute_slots=[0], mem_budget=64 * 1024 * 1024)
LEGACY = dict(n=8, iters=3)


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


def stream_requests(n_waves: int, wave: int):
    """``n_waves`` waves of ``wave`` requests, kernels in turn."""
    from repro.serve import AnalysisRequest
    c = SERVICE
    names = c["kernels"]
    return [[AnalysisRequest(kernel=names[(w * wave + k) % len(names)],
                             n=c["N"], alphas=tuple(c["alphas"]),
                             ms=tuple(c["ms"]),
                             compute_slots=tuple(c["compute_slots"]),
                             deadline_s=c["deadline_s"])
             for k in range(wave)] for w in range(n_waves)]


def outcome(r) -> dict:
    return dict(ok=r.ok, retries=r.retries,
                demotions=r.policy.get("demotions") if r.ok else None,
                batch=len(r.batch_rids),
                error=None if r.ok else r.error["code"])


def drive(spec: str = ""):
    from repro.serve import AnalysisService, faults
    faults.reset()
    for s in faults.parse_spec(spec):
        faults.install(s.stage, s.kind, count=s.count, every=s.every,
                       delay=s.delay, rid=s.rid, min_batch=s.min_batch)
    service = AnalysisService(start=False, backoff_s=SERVICE["backoff_s"])
    results = []
    for wave in stream_requests(SERVICE["n_waves"], SERVICE["wave"]):
        results.extend(service.process(wave))
    faults.reset()
    return results


def service() -> dict:
    from repro.core import schedule_cache as sc
    from repro.serve import AnalysisService, faults
    clean = drive()
    reports = {}
    for r in clean:
        name = r.report["name"]
        rep = {k: plain(v) for k, v in r.report.items()}
        if name in reports and reports[name] != rep:
            raise SystemExit(f"two reports of {name} differ")
        reports[name] = rep
    faulty = drive(SERVICE["transient_spec"])

    faults.reset()
    faults.install("replay", "backend", min_batch=2)
    faults.install("replay", "backend", rid=1)
    out = AnalysisService(start=False, backoff_s=0.0).process(
        stream_requests(1, SERVICE["poisoned_wave"])[0])
    faults.reset()

    os.environ["EDAN_SCHEDULE_CACHE_MIN"] = "0"
    sc.clear()
    (req,) = stream_requests(1, 1)[0]
    AnalysisService(start=False, backoff_s=0.0).process([req])
    sc.reset_stats()
    faults.install("cache-load", "cache", count=1)
    (res,) = AnalysisService(start=False, backoff_s=0.0).process(
        stream_requests(1, 1)[0])
    faults.reset()
    cache_stats = {k: v for k, v in sc.stats.items()
                   if k != "record_seconds"}
    os.environ.pop("EDAN_SCHEDULE_CACHE_MIN")
    if not res.ok:
        raise SystemExit(f"cache-fault request failed: {res.error}")
    return dict(config=SERVICE, reports=reports,
                clean=[outcome(r) for r in clean],
                faulty=[outcome(r) for r in faulty],
                poisoned=[outcome(r) for r in out],
                cache_fault=dict(outcome(res), stats=cache_stats,
                                 kernel=SERVICE["cache_fault_kernel"]))


def persist() -> dict:
    from repro.apps import hpcg, polybench
    from repro.core import sweep_grid
    g = polybench.trace_kernel(GEMM["kernel"], GEMM["N"])
    gemm = dict(GEMM, n_vertices=int(g.n_vertices),
                digest=g.trace_digest(),
                grid=plain(sweep_grid(g, np.asarray(GEMM["alphas"]),
                                      ms=GEMM["ms"],
                                      compute_slots=GEMM["compute_slots"])))
    del g
    g = hpcg.trace_cg(n=HPCG["n"], iters=HPCG["iters"])[0]
    g._finalize()
    grid = sweep_grid(g, np.asarray(HPCG["alphas"]), ms=HPCG["ms"],
                      compute_slots=HPCG["compute_slots"],
                      mem_budget=HPCG["mem_budget"])
    big = dict(HPCG, n_vertices=int(g.n_vertices), n_edges=int(g.n_edges),
               n_levels=int(g.n_levels), digest=g.trace_digest(),
               grid=plain(grid))
    del g
    os.environ["EDAN_LEGACY_BUILD"] = "1"
    try:
        g = hpcg.trace_cg(n=LEGACY["n"], iters=LEGACY["iters"])[0]
    finally:
        os.environ.pop("EDAN_LEGACY_BUILD")
    assert g._legacy
    g._finalize()
    legacy = dict(LEGACY, n_vertices=int(g.n_vertices),
                  n_edges=int(g.n_edges), n_levels=int(g.n_levels),
                  digest=g.trace_digest(),
                  grid=plain(sweep_grid(g, np.asarray(HPCG["alphas"]),
                                        ms=HPCG["ms"],
                                        compute_slots=HPCG["compute_slots"])))
    return dict(gemm=gemm, hpcg=big, legacy=legacy)


def main() -> None:
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        os.environ["EDAN_SCHEDULE_CACHE"] = os.path.join(td, "sched")
        os.environ["EDAN_TRACE_STORE"] = "off"
        for knob in ("EDAN_BACKEND", "EDAN_X64", "EDAN_REPLAY_DTYPE",
                     "EDAN_REPLAY_MEM_BUDGET", "EDAN_FAULTS",
                     "EDAN_SCHEDULE_CACHE_MIN", "EDAN_LEGACY_BUILD",
                     "EDAN_DEADLINE_S", "EDAN_MAX_RETRIES"):
            os.environ.pop(knob, None)
        doc = dict(source="the JAX package on the CPU, recorded by "
                          "tools/service_expected.py",
                   persist=persist(), service=service())
    seconds = time.perf_counter() - t0
    OUT.write_text(json.dumps(doc, indent=None, separators=(",", ":"))
                   + "\n")
    print(f"wrote {OUT} in {seconds:.1f} s")


if __name__ == "__main__":
    main()
