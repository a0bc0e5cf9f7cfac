"""The port's host spans (``repro_torch.core.spans``) on the CPU.

Under ``torch.profiler`` a sweep call emits the ``edan.*`` spans at its
layer boundaries, nested as the layers are: ``edan.k1`` inside
``edan.backend.accumulate`` inside ``edan.replay`` inside one
``edan.grid`` per public call, recordings as ``edan.sched.record`` /
``edan.sched.rerecord`` (one per ``record_runs``), and a union's plan
build, verification and fallback in their own spans.  With no profiler
recording, the path enters no ``record_function`` at all, and the answers
are the same either way.
"""
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as T
from repro_torch.core import metrics as tmetrics
from repro_torch.core import scheduler as tsched
from repro_torch.core import spans
from repro_torch.core import suite as tsuite

TIES = [0.5, 1.0, 2.0, 3.0, 50.0, 200.0]
DTYPES = [None, "float32"]


@pytest.fixture(autouse=True)
def cpu_backend(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")
    for knob in ("EDAN_X64", "EDAN_REPLAY_DTYPE", "EDAN_BACKEND",
                 "EDAN_REPLAY_MEM_BUDGET"):
        monkeypatch.delenv(knob, raising=False)


def rand_dag(seed: int, n: int, p_edge: float = 0.12,
             p_mem: float = 0.5) -> T.EDag:
    rng = np.random.default_rng(seed)
    is_mem = rng.random(n) < p_mem
    src, dst = [], []
    for i in range(n):
        for j in range(i):
            if rng.random() < p_edge:
                src.append(j)
                dst.append(i)
    g = T.EDag()
    g.add_vertex_block(np.where(is_mem, 0.0, 1.0), is_mem,
                       np.full(n, 8.0), n=n)
    g.add_edge_block(np.asarray(src, dtype=np.int64),
                     np.asarray(dst, dtype=np.int64))
    g._finalize()
    return g


def profiled(fn):
    """``fn()`` under a CPU profiler: (its result, the ``edan.*`` spans as
    ``(name, start_ns, end_ns)``, the change in ``record_runs``)."""
    r0 = tsched.stats["record_runs"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ev = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("edan.")), key=lambda e: e[1])
    return out, ev, tsched.stats["record_runs"] - r0


def parent(ev, span):
    """The innermost other span that encloses ``span``."""
    best = None
    for e in ev:
        if e is not span and e[1] <= span[1] and span[2] <= e[2] and \
                (best is None or e[2] - e[1] < best[2] - best[1]):
            best = e
    return best


def chain(ev, span) -> list:
    out = []
    while span is not None:
        out.append(span[0])
        span = parent(ev, span)
    return out


def check_common(ev, records: int, analytic: bool = False) -> Counter:
    """Checks every sweep call's spans pass; ``analytic`` lets the report
    layer's span passes (``t_inf``), which run before its sweep, lie
    outside ``edan.grid``."""
    names = Counter(e[0] for e in ev)
    assert names["edan.grid"] == 1
    assert names["edan.sched.record"] + names["edan.sched.rerecord"] == \
        records
    assert names["edan.k1"] >= 1
    for e in ev:
        c = chain(ev, e)
        if analytic and set(c) <= {"edan.k1", "edan.backend.accumulate"}:
            continue
        assert c[-1] == "edan.grid", c
        if e[0] == "edan.k1":
            assert c[1:3] == ["edan.backend.accumulate", "edan.replay"], c
        if e[0] == "edan.verify":
            assert "edan.replay" not in c, c
    return names


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_sweep_grid_emits_nested_spans(dtype):
    g = rand_dag(0, 60)
    _, ev, records = profiled(lambda: T.sweep_grid(
        g, TIES, ms=(2, 4), compute_slots=(0, 2), replay_dtype=dtype))
    names = check_common(ev, records)
    # four (m, slots) pairs recorded afresh, tie-shifted points re-recorded
    assert names["edan.sched.record"] == 4
    assert names["edan.sched.rerecord"] >= 1
    assert names["edan.verify"] == names["edan.replay"]
    assert names["edan.k1"] >= names["edan.backend.accumulate"] == \
        names["edan.replay"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_suite_sweep_grid_emits_nested_spans(dtype):
    members = [rand_dag(31, 70), rand_dag(32, 55), rand_dag(33, 40)]
    s = T.EDagSuite(members)
    fb = tsuite.stats["fallback_points"]
    _, ev, records = profiled(lambda: T.suite_sweep_grid(
        s, TIES, ms=(2,), compute_slots=(0, 1), replay_dtype=dtype))
    names = check_common(ev, records)
    assert names["edan.suite.plan"] == 1
    # every member recording of the union is nested in the plan's build
    for e in ev:
        if e[0] == "edan.sched.record" and \
                "edan.suite.fallback" not in chain(ev, e):
            assert chain(ev, e)[1] == "edan.suite.plan"
    # the tie-heavy points fall back per member, inside the same grid
    assert tsuite.stats["fallback_points"] > fb
    assert names["edan.suite.fallback"] == 1
    assert names["edan.verify"] == names["edan.replay"]


def _class_dag():
    g = rand_dag(5, 50)
    g.set_mem_classes(np.arange(g.n_vertices) % 2)
    return g


CALLS = {
    "simulate_batch": lambda: T.simulate_batch(rand_dag(1, 40), TIES, m=2),
    "latency_sweep": lambda: T.latency_sweep(rand_dag(2, 40), TIES, m=2,
                                             compute_slots=1),
    "sweep_grid.classes": lambda: T.sweep_grid(
        _class_dag(), np.array([[1.0, 2.0], [2.0, 1.0], [50.0, 3.0]]),
        ms=(2,)),
    "grid_report": lambda: tmetrics.grid_report(
        rand_dag(3, 40), TIES, ms=(2,), simulate_points=True),
    "suite_latency_sweep": lambda: T.suite_latency_sweep(
        T.EDagSuite([rand_dag(4, 30), rand_dag(6, 35)]), TIES, m=2),
    "suite_grid_report": lambda: tmetrics.suite_grid_report(
        T.EDagSuite([rand_dag(7, 30), rand_dag(8, 35)]), TIES, ms=(2,),
        simulate_points=True),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_each_public_sweep_call_opens_one_grid_span(call):
    out, ev, records = profiled(CALLS[call])
    check_common(ev, records, analytic=call.endswith("report"))
    # the profiler changes no answer
    assert _same(out, CALLS[call]())


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler recording, the sweep path enters nothing: every
    span is the shared no-op context."""
    def boom(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    assert spans.span("edan.x") is spans.grid_span()
    runs = tsched.stats["record_runs"]
    for fn in CALLS.values():
        fn()
    T.suite_sweep_grid(T.EDagSuite([rand_dag(31, 70), rand_dag(32, 55)]),
                       TIES, ms=(2,), compute_slots=(0, 1),
                       replay_dtype="float32")
    # the recordings are counted with the spans off as with them on
    assert tsched.stats["record_runs"] > runs


def test_a_grid_span_is_not_reopened_inside_another():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.grid_span():
            with spans.grid_span():
                with spans.span("edan.verify"):
                    pass
        with spans.grid_span():
            pass
    names = Counter(e.name() for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("edan."))
    assert names == {"edan.grid": 2, "edan.verify": 1}


def test_a_recording_counts_its_runs_and_seconds():
    g = rand_dag(9, 60)
    st = tsched.stats.snapshot()
    T.sweep_grid(g, TIES, ms=(2,), compute_slots=(1,))
    d = {k: tsched.stats[k] - st[k] for k in ("record_runs",
                                                "record_seconds")}
    assert d["record_runs"] >= 2 and d["record_seconds"] > 0.0
