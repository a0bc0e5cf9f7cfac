"""Write the model-zoo tracing fixture for the PyTorch port.

Traces the port's model zoo on the CPU (``repro_torch.models.tracing``,
``meta`` inputs) and runs the JAX package's analyses on the port's own
eDAGs, which reach it through ``EDag.from_arrays``:

* ``port_traces``: each ``ZOO`` config at the reduced width, prefill and
  decode, and the train phase of ``TRAIN``'s configs (seq_len 32, batch
  2, the tracing defaults): vertices, edges, memory vertices, digest and
  the ``dot_general`` vertices' count and FLOPs; ``full_trace``: qwen3-0.6b
  decode at full width, its depth cut to ``FULL_LAYERS`` of its 28
  layers, the same summary;
* ``reference_traces``: the JAX package's own trace of the same requests
  (``repro.models.tracing.trace_model``), the same counts beside them (the
  frameworks decompose the models differently: ROADMAP §C 15);
* ``grid``: the JAX package's ``suite_grid_report`` of the union of the
  six port prefill traces (alphas ``linspace(50, 300, 13)``, m (2, 4, 8),
  ALU slots (0, 8)), what ``model_grid_report`` must return;
* ``service``: model requests (``SERVICE``) — a clean one, a union batch
  of three, a transient and a hard ``trace-model`` fault — through the
  JAX package's ``AnalysisService``: the outcomes of its own model
  requests, and the reports of the port's eDAGs uploaded as traces under
  the model requests' names.

Writes ``src/repro_torch/configs/zoo_expected.json``.  Deterministic: two
runs write the same bytes.

Usage: PYTHONPATH=src JAX_PLATFORMS=cpu python tools/zoo_expected.py
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np

from service_expected import outcome, plain

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "configs" / "zoo_expected.json"

TRAIN = ("qwen3-0.6b", "seamless-m4t-large-v2")
FULL = ("qwen3-0.6b", "decode")
#: the full-width trace's depth (``chip_smoke.py`` phase "zoo" times it)
FULL_LAYERS = 4
GRID = dict(alphas=np.linspace(50.0, 300.0, 13).tolist(), ms=[2, 4, 8],
            compute_slots=[0, 8])
SERVICE = dict(phase="decode", alphas=[60.0, 140.0, 200.0], ms=[2, 4],
               compute_slots=[0],
               union=["qwen3-0.6b", "rwkv6-7b", "seamless-m4t-large-v2"],
               max_retries_hard=1)


def requests_of(zoo) -> list:
    """(name, phase) of every reduced trace the fixture records."""
    return ([(n, ph) for n in zoo.values() for ph in ("prefill", "decode")]
            + [(n, "train") for n in TRAIN])


def dot_flops(g) -> tuple:
    """(count, FLOPs) of the ``dot_general`` vertices."""
    labels = g.labels()
    idx = [i for i, lab in enumerate(labels) if lab == "dot_general"]
    return len(idx), float(np.asarray(g.cost)[idx].sum())


def summary(g, digest: bool = True) -> dict:
    g._finalize()
    n_dot, flops = dot_flops(g)
    out = dict(vertices=int(g.n_vertices), edges=int(g.n_edges),
               mem_vertices=int(g.is_mem.sum()), dot_count=n_dot,
               dot_flops=flops)
    if digest:
        out["digest"] = g.trace_digest()
    return out


def reference_edag(g):
    """The port's eDAG as the JAX package's ``EDag``."""
    import repro.core as R
    g._finalize()
    return R.EDag.from_arrays(g.cost, g.is_mem, g.nbytes, g.src, g.dst,
                              labels=list(g.labels()))


def service_requests(pkg, configs, traces=None, **kw) -> list:
    """Model requests of ``configs`` for the package ``pkg``
    (``repro.serve`` or ``repro_torch.serve``); with ``traces`` the
    reference uploads the port's eDAGs under the same names instead."""
    grid = dict(alphas=tuple(SERVICE["alphas"]), ms=tuple(SERVICE["ms"]),
                compute_slots=tuple(SERVICE["compute_slots"]))
    out = []
    for name in configs:
        if traces is None:
            out.append(pkg.AnalysisRequest(config=name, kind="model",
                                           phase=SERVICE["phase"], **grid,
                                           **kw))
        else:
            out.append(pkg.AnalysisRequest(
                trace=reference_edag(traces[name]),
                name=f"{name}:{SERVICE['phase']}", **grid, **kw))
    return out


def service(port_traces) -> dict:
    import repro.serve as RS
    from repro.serve import AnalysisService, faults

    def run(reqs, fault=None):
        faults.reset()
        if fault is not None:
            faults.install("trace-model", "io", **fault)
        try:
            return AnalysisService(start=False, backoff_s=0.0).process(reqs)
        finally:
            faults.reset()

    one, union = SERVICE["union"][:1], SERVICE["union"]
    out = dict(
        clean=[outcome(r) for r in run(service_requests(RS, one))],
        union=[outcome(r) for r in run(service_requests(RS, union))],
        transient=[outcome(r) for r in run(service_requests(RS, one),
                                           dict(count=1))],
        hard=[outcome(r) for r in run(service_requests(
            RS, one, max_retries=SERVICE["max_retries_hard"]), {})])
    reports = {}
    for res in run(service_requests(RS, union, port_traces)):
        assert res.ok and len(res.batch_rids) == len(union)
        reports[res.report["name"]] = plain(res.report)
    for res in run(service_requests(RS, one, port_traces)):
        if plain(res.report) != reports[res.report["name"]]:
            raise SystemExit("the union's report differs from the solo one")
    out["reports"] = reports
    return out


def main() -> None:
    os.environ.setdefault("EDAN_TORCH_BACKEND", "cpu")
    os.environ["EDAN_SCHEDULE_CACHE"] = "off"
    os.environ.pop("EDAN_TRACE_STORE", None)
    import repro.core as R
    from repro.models import tracing as RT
    from repro_torch.configs import get_config
    from repro_torch.models import tracing as PT
    port, ref, graphs = {}, {}, {}
    for name, phase in requests_of(PT.ZOO):
        key = f"{name}:{phase}"
        graphs[key] = PT.trace_model(name, phase, use_store=False)
        port[key] = summary(graphs[key])
        ref[key] = summary(RT.trace_model(name, phase, use_store=False),
                           digest=False)
        print(f"{key}: port {port[key]['vertices']} vertices, reference "
              f"{ref[key]['vertices']}", flush=True)
    full = summary(PT.trace_model(
        dataclasses.replace(get_config(FULL[0]), n_layers=FULL_LAYERS),
        FULL[1], use_store=False))
    names = list(PT.ZOO.values())
    suite = R.EDagSuite([reference_edag(graphs[f"{n}:prefill"])
                         for n in names], names=names)
    grid = R.suite_grid_report(suite, GRID["alphas"], ms=GRID["ms"],
                               compute_slots=GRID["compute_slots"])
    grid["names"] = names
    svc = service({n: graphs[f"{n}:{SERVICE['phase']}"]
                   for n in SERVICE["union"]})
    doc = dict(config=dict(zoo=PT.ZOO, train=list(TRAIN), full=list(FULL),
                           full_layers=FULL_LAYERS,
                           seq_len=32, batch_size=2,
                           mem_threshold_bytes=PT.DEFAULT_MEM_THRESHOLD,
                           grid=GRID, service=SERVICE),
               port_traces=port, reference_traces=ref, full_trace=full,
               grid=plain(grid), service=svc)
    OUT.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
