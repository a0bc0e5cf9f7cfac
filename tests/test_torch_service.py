"""The port's analysis service and fault layer (``repro_torch.serve``)
against the JAX package's, on the CPU.

The cases of ``tests/test_analysis_service.py`` and ``tests/test_faults.py``
and the service knobs of ``tests/test_env_hardening.py``.  Each service
case runs its scenario through both packages (``both``): the reference on
its ``numpy`` backend, the port on ``cpu``, with the same requests, the
same injected faults and the same replay dtype, so both demotion ladders
have the same length.  Every result must agree: ok flags, error codes,
stages and retries, batch membership, demotions and the rung index a
result ended on (names differ: the port reports its own backends), and
every report bit for bit.  The case's own assertions then hold on each
package's results.

The reference's model-request cases run through both packages too, each
tracing its own model eDAG (``models/tracing.py``): their outcomes must
agree, and the port's reports must equal its own solo runs and the JAX
package's ``grid_report`` of the port's eDAG.  The reference's in-kernel
fault case becomes a card test of the visible demotion
(``tests/test_torch_gpu.py``), since the port's kernel hook fires only for
tensors on the card.
"""
import json
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as R
import repro.serve as RS
import repro_torch.core as T
import repro_torch.serve as TS
from repro.core.plan import REPLAY_BYTES_PER_CELL as R_CELL
from repro.serve import analysis as ranalysis
from repro_torch.core import backend as tbk
from repro_torch.core import schedule_cache as tsc
from repro_torch.core.plan import REPLAY_BYTES_PER_CELL as T_CELL
from repro_torch.serve import analysis as tanalysis

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

PKGS = {
    "repro": SimpleNamespace(name="repro", core=R, serve=RS,
                             faults=RS.faults, analysis=ranalysis,
                             backend="numpy", cell=R_CELL),
    "repro_torch": SimpleNamespace(name="repro_torch", core=T, serve=TS,
                                   faults=TS.faults, analysis=tanalysis,
                                   backend="cpu", cell=T_CELL),
}
REF, PORT = PKGS["repro"], PKGS["repro_torch"]

ALPHAS = (60.0, 140.0)
GRID = dict(alphas=ALPHAS, ms=(2, 4), compute_slots=(0,))


@pytest.fixture(autouse=True)
def clean_env(monkeypatch, tmp_path):
    """Deterministic fault, cache and backend environment."""
    monkeypatch.delenv("EDAN_FAULTS", raising=False)
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", str(tmp_path / "sched"))
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    for knob in ("EDAN_X64", "EDAN_REPLAY_DTYPE", "EDAN_BACKEND",
                 "EDAN_REPLAY_MEM_BUDGET", "EDAN_DEADLINE_S",
                 "EDAN_MAX_RETRIES"):
        monkeypatch.delenv(knob, raising=False)
    for P in PKGS.values():
        P.faults.reset()
    yield
    for P in PKGS.values():
        P.faults.reset()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def rand_edag(P, seed: int, n: int = 40, p_edge: float = 0.12):
    rng = np.random.default_rng(seed)
    g = P.core.EDag()
    for i in range(n):
        g.add_vertex(is_mem=bool(rng.random() < 0.5))
        for j in range(i):
            if rng.random() < p_edge:
                g.add_edge(j, i)
    return g


def svc(P, **kw):
    kw.setdefault("start", False)
    kw.setdefault("backoff_s", 0.0)
    return P.serve.AnalysisService(**kw)


def req(P, seed: int, **kw):
    for k, v in GRID.items():
        kw.setdefault(k, v)
    kw.setdefault("backend", P.backend)
    return P.serve.AnalysisRequest(trace=rand_edag(P, seed), **kw)


def placement_trace(P, seed: int = 0, n_obj: int = 3, n_ops: int = 24):
    rng = np.random.default_rng(seed)
    tr = P.core.Tracer()
    arrs = [tr.array(np.arange(8.0 * (i + 1)), f"obj{i}")
            for i in range(n_obj)]
    acc = tr.const(0.0)
    for _ in range(n_ops):
        a = arrs[rng.integers(n_obj)]
        acc = tr.alu("+", acc, a.load(int(rng.integers(len(a.arr)))))
        if rng.random() < 0.4:
            b = arrs[rng.integers(n_obj)]
            b.store(int(rng.integers(len(b.arr))), acc)
    return tr.g, tr.object_sizes()


def preq(P, seed: int = 0, **kw):
    g, sizes = placement_trace(P, seed)
    kw.setdefault("object_sizes", sizes)
    kw.setdefault("local_budget", sum(sizes.values()) // 2)
    kw.setdefault("backend", P.backend)
    return P.serve.AnalysisRequest(trace=g, kind="placement", **kw)


# ------------------------------------------------------------ comparison

def same_value(a, b, path="") -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            same_value(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (np.ndarray, np.generic)) or \
            isinstance(b, (np.ndarray, np.generic)):
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, path
        assert x.tobytes() == y.tobytes(), path
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same_value(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert np.float64(a).tobytes() == np.float64(b).tobytes(), path
    else:
        assert a == b and type(a) is type(b), path


def rung(P, r, res) -> int:
    """The index of the rung ``res`` was answered on, in the ladder of
    the request ``r``."""
    ladder = P.core.ExecPolicy.resolve(
        backend=r.backend, replay_dtype=r.replay_dtype).ladder()
    return [(p.backend, p.replay_dtype) for p in ladder].index(
        (res.policy["backend"], res.policy["replay_dtype"]))


def same_results(reqs_r, out_r, reqs_t, out_t) -> None:
    assert len(out_r) == len(out_t)
    for qr, a, qt, b in zip(reqs_r, out_r, reqs_t, out_t):
        assert (a.rid, a.ok, a.retries, a.batch_rids, a.stored) == \
            (b.rid, b.ok, b.retries, b.batch_rids, b.stored)
        if a.ok:
            same_value(a.report, b.report)
            assert a.policy["demotions"] == b.policy["demotions"]
            assert rung(REF, qr, a) == rung(PORT, qt, b)
            assert sorted(a.policy) == sorted(b.policy)
        else:
            assert a.report is None and b.report is None
            assert sorted(a.error) == sorted(b.error)
            for k in ("code", "stage", "retries"):
                assert a.error[k] == b.error[k], k


def both(scenario):
    """Run ``scenario(P) -> [(requests, results), ...]`` in both packages
    and hold the port's results to the reference's; returns
    ``{name: [results, ...]}``."""
    got = {}
    for P in (REF, PORT):
        P.faults.reset()
        try:
            got[P.name] = scenario(P)
        finally:
            P.faults.reset()
    for (qr, ar), (qt, at) in zip(got["repro"], got["repro_torch"]):
        same_results(qr, ar, qt, at)
    return {k: [out for _, out in v] for k, v in got.items()}


def process(service, reqs):
    return reqs, service.process(reqs)


def assert_reports_equal(a: dict, b: dict):
    for key in ("alphas", "ms", "compute_slots", "lam", "t_inf",
                "t_lower", "t_upper", "Lam", "simulated"):
        assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key
    for key in ("W", "D", "C"):
        assert a[key] == b[key]


# ---------------------------------------------------------------- happy path

def test_single_request_matches_grid_report():
    def scenario(P):
        return [process(svc(P), [P.serve.AnalysisRequest(
            trace=rand_edag(P, 0), backend=P.backend, **GRID)])]

    for name, (out,) in both(scenario).items():
        (res,) = out
        assert res.ok and res.error is None and res.retries == 0
        assert res.batch_rids == (res.rid,)
        want = R.grid_report(rand_edag(REF, 0), list(ALPHAS), ms=GRID["ms"],
                             compute_slots=GRID["compute_slots"],
                             simulate_points=True, backend="numpy")
        assert np.array_equal(res.report["simulated"], want["simulated"])
        assert np.array_equal(res.report["t_inf"], want["t_inf"])
        assert res.report["W"] == float(want["W"])


@pytest.mark.parametrize("dtype", [None, "float32"])
def test_batched_results_bit_identical_to_solo(dtype):
    def scenario(P):
        runs = [process(svc(P), [req(P, s, replay_dtype=dtype)
                                 for s in (0, 1, 2)])]
        runs += [process(svc(P), [req(P, s, replay_dtype=dtype)])
                 for s in (0, 1, 2)]
        return runs

    for name, (batched, *solos) in both(scenario).items():
        assert all(r.ok for r in batched)
        assert all(len(r.batch_rids) == 3 for r in batched)
        for got, (solo,) in zip(batched, solos):
            assert solo.ok and solo.batch_rids == (solo.rid,)
            assert_reports_equal(got.report, solo.report)


def test_union_alpha_slicing():
    def scenario(P):
        return [process(svc(P), [req(P, 0, alphas=(60.0, 140.0)),
                                 req(P, 1, alphas=(100.0, 220.0))]),
                process(svc(P), [req(P, 0, alphas=(60.0, 140.0))]),
                process(svc(P), [req(P, 1, alphas=(100.0, 220.0))])]

    for name, ((a, b), (sa,), (sb,)) in both(scenario).items():
        assert a.ok and b.ok and len(a.batch_rids) == 2
        assert a.report["alphas"].tolist() == [60.0, 140.0]
        assert b.report["alphas"].tolist() == [100.0, 220.0]
        assert_reports_equal(a.report, sa.report)
        assert_reports_equal(b.report, sb.report)


def test_incompatible_grids_do_not_batch():
    def scenario(P):
        return [process(svc(P), [req(P, 0, ms=(2,)), req(P, 1, ms=(4,))])]

    for name, ((a, b),) in both(scenario).items():
        assert a.ok and b.ok
        assert a.batch_rids == (a.rid,) and b.batch_rids == (b.rid,)


def test_memory_budget_splits_batches_and_priority_packs_first():
    def scenario(P):
        def trace_bytes(seed):
            g = rand_edag(P, seed)
            g._finalize()
            return sum(g.array_nbytes().values())

        n_pairs = len(GRID["ms"]) * len(GRID["compute_slots"])
        budget = (2 * 40 * n_pairs * len(ALPHAS) * P.cell
                  + trace_bytes(1) + trace_bytes(2))
        return [process(svc(P, mem_budget=budget),
                        [req(P, 0, priority=0), req(P, 1, priority=5),
                         req(P, 2, priority=5)])]

    for name, (out,) in both(scenario).items():
        assert all(r.ok for r in out)
        lo, hi1, hi2 = out
        assert set(hi1.batch_rids) == {hi1.rid, hi2.rid}
        assert lo.batch_rids == (lo.rid,)


def test_kernel_traced_server_side():
    def scenario(P):
        b = P.backend
        return [process(svc(P), [P.serve.AnalysisRequest(
                    kernel="atax", n=6, backend=b, **GRID)]),
                process(svc(P), [P.serve.AnalysisRequest(
                    kernel="cg", n=3, alphas=(100.0,), backend=b)])]

    for name, ((res,), (cg,)) in both(scenario).items():
        assert res.ok and res.report["name"] == "atax"
        assert cg.ok


def test_unknown_kernel_fails_with_choices():
    def scenario(P):
        return [process(svc(P), [P.serve.AnalysisRequest(
            kernel="ataxx", n=6, alphas=(100.0,), max_retries=0,
            backend=P.backend)])]

    for name, ((res,),) in both(scenario).items():
        assert not res.ok and res.error["code"] == "load-error"
        assert "atax" in res.error["message"]


def test_request_validation(pkg):
    A = pkg.serve.AnalysisRequest
    with pytest.raises(ValueError):
        A(alphas=(100.0,))
    with pytest.raises(ValueError):
        A(trace=rand_edag(pkg, 0), kernel="atax")
    with pytest.raises(ValueError):
        A(kernel="atax", deadline_s=0.0)
    with pytest.raises(ValueError):
        A(kernel="atax", max_retries=-1)


def mreq(P, config="qwen3-0.6b", phase="decode", **kw):
    for k, v in GRID.items():
        kw.setdefault(k, v)
    kw.setdefault("backend", P.backend)
    return P.serve.AnalysisRequest(config=config, phase=phase, kind="model",
                                   **kw)


def same_outcomes(out_r, out_t) -> None:
    """The reference's and the port's results agree in everything but the
    reports (each package traces its own model eDAG)."""
    assert len(out_r) == len(out_t)
    for a, b in zip(out_r, out_t):
        assert (a.rid, a.ok, a.retries, a.batch_rids, a.stored) == \
            (b.rid, b.ok, b.retries, b.batch_rids, b.stored)
        if a.ok:
            assert a.report["name"] == b.report["name"]
            assert a.policy["demotions"] == b.policy["demotions"]
        else:
            for k in ("code", "stage", "retries"):
                assert a.error[k] == b.error[k], k


def reference_grid(g, **kw):
    """The JAX package's ``grid_report`` of the port's eDAG."""
    g._finalize()
    rg = R.EDag.from_arrays(g.cost, g.is_mem, g.nbytes, g.src, g.dst)
    return R.grid_report(rg, list(ALPHAS), ms=GRID["ms"],
                         compute_slots=GRID["compute_slots"],
                         simulate_points=True, **kw)


def test_model_request_matches_direct_grid_report():
    """kind='model' traces the config server-side; the report is the
    port's ``trace_model`` + ``grid_report`` by hand, bit for bit, and the
    JAX package's ``grid_report`` of the same eDAG."""
    from repro_torch.models.tracing import trace_model
    (res,) = svc(PORT).process([mreq(PORT)])
    assert res.ok and res.error is None
    assert res.report["name"] == "qwen3-0.6b:decode"
    g = trace_model("qwen3-0.6b", "decode", use_store=False)
    want = T.grid_report(g, list(ALPHAS), ms=GRID["ms"],
                         compute_slots=GRID["compute_slots"],
                         simulate_points=True, backend="cpu")
    for w in (want, reference_grid(g)):
        assert res.report["W"] == float(w["W"])
        assert res.report["D"] == float(w["D"])
        for key in ("simulated", "t_inf", "t_lower", "t_upper", "Lam"):
            assert np.array_equal(res.report[key], w[key]), key
    (ref,) = svc(REF).process([mreq(REF)])
    same_outcomes([ref], [res])


def test_model_requests_join_union_batches():
    """Model requests are ordinary grid members: two configs plus an
    uploaded trace co-batch into one union, every result bit-identical to
    its solo run; the reference answers the same requests alike."""
    def reqs(P):
        return [mreq(P, "qwen3-0.6b"), mreq(P, "rwkv6-7b"), req(P, 0)]

    batched = svc(PORT).process(reqs(PORT))
    assert all(r.ok for r in batched)
    assert all(len(r.batch_rids) == 3 for r in batched)
    for r, solo_req in zip(batched, reqs(PORT)):
        (solo,) = svc(PORT).process([solo_req])
        assert_reports_equal(r.report, solo.report)
    same_outcomes(svc(REF).process(reqs(REF)), batched)


def test_transient_trace_model_fault_recovers():
    def scenario(P):
        P.faults.install("trace-model", "io", count=1)
        return [process(svc(P), [mreq(P)])]

    got = both_outcomes(scenario)
    for (res,) in got.values():
        assert res.ok and res.retries == 1


def test_hard_trace_model_fault_structured():
    def scenario(P):
        P.faults.install("trace-model", "io")    # every attempt
        return [process(svc(P), [mreq(P, max_retries=1)])]

    got = both_outcomes(scenario)
    for (res,) in got.values():
        assert not res.ok
        assert res.error["code"] == "load-error"
        assert res.error["stage"] == "trace-model"
        assert res.retries >= 1


def test_unknown_config_fails_with_choices():
    def scenario(P):
        return [process(svc(P), [mreq(P, "not-a-model", max_retries=0)])]

    for (res,) in both_outcomes(scenario).values():
        assert not res.ok and res.error["code"] == "load-error"
        assert "qwen3-0.6b" in res.error["message"]


def both_outcomes(scenario):
    """``both`` for model requests: the outcomes agree, the reports are
    each package's own."""
    got = {}
    for P in (REF, PORT):
        P.faults.reset()
        try:
            got[P.name] = scenario(P)
        finally:
            P.faults.reset()
    for (_, ar), (_, at) in zip(got["repro"], got["repro_torch"]):
        same_outcomes(ar, at)
    return {k: v[0][1] for k, v in got.items()}


def test_model_request_validation(pkg):
    A = pkg.serve.AnalysisRequest
    with pytest.raises(ValueError, match="phase"):
        A(config="qwen3-0.6b", kind="model", phase="serve")
    with pytest.raises(ValueError, match="kind='model'"):
        A(config="qwen3-0.6b")
    with pytest.raises(ValueError, match="exactly one"):
        A(config="qwen3-0.6b", kernel="atax", kind="model")
    with pytest.raises(ValueError, match="config="):
        A(kind="model")
    assert "trace-model" in pkg.faults.STAGES


def test_model_requests_wait_for_the_tracing_frontend():
    """The tracing frontend is in: a model request of every phase is valid
    in the port, as in the reference, and both name the same phases."""
    from repro.models.tracing import PHASES
    from repro_torch.models.tracing import PHASES as TPHASES
    assert TPHASES == PHASES
    for phase in PHASES:
        for P in (REF, PORT):
            r = P.serve.AnalysisRequest(config="qwen3-0.6b", kind="model",
                                        phase=phase)
            assert (r.kind, r.phase) == ("model", phase)


# ------------------------------------------------------- retries + demotion

def test_transient_load_fault_recovers():
    def scenario(P):
        P.faults.install("load", "io", count=1)
        return [process(svc(P), [req(P, 0)])]

    for name, ((res,),) in both(scenario).items():
        assert res.ok and res.retries == 1


def test_transient_finalize_fault_recovers():
    def scenario(P):
        P.faults.install("finalize", "backend", count=1)
        return [process(svc(P), [req(P, 0)])]

    for name, ((res,),) in both(scenario).items():
        assert res.ok and res.retries == 1


def test_transient_replay_fault_demotes_and_recovers():
    """One replay failure walks one rung down the ladder; a float32
    request's ladder is (float32, float64) on the host in both packages."""
    def scenario(P):
        P.faults.install("replay", "backend", count=1)
        out = [process(svc(P), [req(P, 0, replay_dtype="float32")])]
        P.faults.reset()
        return out + [process(svc(P), [req(P, 0, replay_dtype="float32")])]

    got = both(scenario)
    for name, ((res,), (clean,)) in got.items():
        assert res.ok and res.retries == 1
        assert res.policy["demotions"] == 1
        assert clean.policy["demotions"] == 0
        assert_reports_equal(res.report, clean.report)
    (res,), _ = got["repro_torch"]
    assert (res.policy["backend"], res.policy["replay_dtype"]) == \
        ("cpu", "float64")


def test_retry_budget_exhaustion_is_structured():
    def scenario(P):
        P.faults.install("replay", "backend")
        return [process(svc(P), [req(P, 0, max_retries=1)])]

    for name, ((res,),) in both(scenario).items():
        assert not res.ok
        e = res.error
        assert e["code"] == "replay-error" and e["stage"] == "replay"
        assert set(e) == {"code", "stage", "message", "retries"}
        assert res.retries >= 1


def test_transient_report_fault_recovers():
    def scenario(P):
        P.faults.install("report", "io", count=1)
        return [process(svc(P), [req(P, 0)])]

    for name, ((res,),) in both(scenario).items():
        assert res.ok and res.retries == 1


def test_kernel_fault_never_fires_on_the_host():
    """The port's kernel hook sits in the card's dispatch: on the host it
    is attached but never fires, and the answer is the clean one."""
    PORT.faults.install("kernel", "backend")
    assert tbk.fault_hook is not None
    (res,) = svc(PORT).process([req(PORT, 0)])
    assert res.ok and res.policy["demotions"] == 0
    assert PORT.faults.fire_log == {}
    PORT.faults.reset()
    (clean,) = svc(PORT).process([req(PORT, 0)])
    same_value(res.report, clean.report)


# --------------------------------------------------------- poison isolation

@pytest.mark.parametrize("dtype", [None, "float32"])
def test_poisoned_member_never_corrupts_cobatched_results(dtype):
    def scenario(P):
        runs = [process(svc(P), [req(P, s, replay_dtype=dtype)])
                for s in (0, 1, 2)]
        service = svc(P)
        P.faults.install("replay", "backend", min_batch=2)
        P.faults.install("replay", "backend", rid=1)
        runs.append(process(service, [req(P, s, replay_dtype=dtype)
                                      for s in (0, 1, 2)]))
        P.faults.reset()
        runs.append(process(service, [req(P, 1, replay_dtype=dtype),
                                      req(P, 2, replay_dtype=dtype)]))
        return runs

    for name, ((r0,), (r1,), (r2,), out, again) in both(scenario).items():
        healthy0, poisoned, healthy2 = out
        assert healthy0.ok and healthy2.ok and not poisoned.ok
        assert poisoned.error["code"] == "replay-error"
        assert healthy0.batch_rids == (healthy0.rid,)
        assert healthy2.batch_rids == (healthy2.rid,)
        assert_reports_equal(healthy0.report, r0.report)
        assert_reports_equal(healthy2.report, r2.report)
        assert not again[0].ok and again[0].error["code"] == "quarantined"
        assert again[1].ok
        assert_reports_equal(again[1].report, r2.report)


def test_quarantine_is_per_service_not_global():
    def scenario(P):
        P.faults.install("replay", "backend")
        out = [process(svc(P), [req(P, 7, max_retries=0)])]
        P.faults.reset()
        return out + [process(svc(P), [req(P, 7)])]

    for name, ((bad,), (fresh,)) in both(scenario).items():
        assert not bad.ok and fresh.ok


# ------------------------------------------------------------------ deadline

def test_deadline_exceeded_fails_alone():
    def scenario(P):
        P.faults.install("load", "latency", rid=0, delay=0.3)
        out = [process(svc(P), [req(P, 0, deadline_s=0.05, max_retries=0),
                                req(P, 1, deadline_s=60.0)])]
        P.faults.reset()
        return out + [process(svc(P), [req(P, 1)])]

    for name, ((slow, fast), (ref,)) in both(scenario).items():
        assert not slow.ok
        assert slow.error["code"] == "deadline"
        assert slow.error["stage"] == "load"
        assert fast.ok
        assert_reports_equal(fast.report, ref.report)


def test_deadline_checked_between_retries(pkg):
    pkg.faults.install("replay", "backend")
    t0 = time.monotonic()
    (res,) = svc(pkg, backoff_s=0.05).process(
        [req(pkg, 0, deadline_s=0.2, max_retries=1000)])
    assert not res.ok and res.error["code"] == "deadline"
    assert time.monotonic() - t0 < 30.0


def test_env_defaults_applied_at_admission(monkeypatch):
    def scenario(P):
        monkeypatch.setenv("EDAN_DEADLINE_S", "0.0001")
        P.faults.install("load", "latency", delay=0.05)
        out = [process(svc(P), [req(P, 0)])]
        monkeypatch.setenv("EDAN_DEADLINE_S", "60")
        monkeypatch.setenv("EDAN_MAX_RETRIES", "0")
        P.faults.reset()
        P.faults.install("replay", "backend", count=1)
        out.append(process(svc(P), [req(P, 0)]))
        monkeypatch.delenv("EDAN_DEADLINE_S")
        monkeypatch.delenv("EDAN_MAX_RETRIES")
        return out

    for name, ((res,), (res2,)) in both(scenario).items():
        assert not res.ok and res.error["code"] == "deadline"
        # zero retries and a one-rung host ladder: the transient is fatal
        assert not res2.ok and res2.error["code"] == "replay-error"


# --------------------------------------------------------------- placement

def test_placement_request_matches_direct_search():
    def scenario(P):
        return [process(svc(P), [preq(P, 0)])]

    g, sizes = placement_trace(REF, 0)
    want = R.search_placement(g, 1.0, 200.0, sum(sizes.values()) // 2,
                              sizes=sizes, m=4, compute_slots=0,
                              backend="numpy")
    for name, ((res,),) in both(scenario).items():
        assert res.ok and res.error is None and res.retries == 0
        rep = res.report
        assert rep["kind"] == "placement"
        assert rep["method"] == want.method
        assert tuple(rep["local"]) == want.local
        assert rep["makespan"] == want.makespan
        assert rep["all_local"] == want.all_local
        assert rep["all_remote"] == want.all_remote
        assert np.array_equal(np.asarray(rep["budgets"]), want.budgets)
        assert np.array_equal(np.asarray(rep["curve"]), want.curve)
        assert set(rep["marginal"]) == set(want.marginal)


def test_placement_runs_solo_in_a_mixed_wave():
    def scenario(P):
        runs = [process(svc(P), [req(P, s)]) for s in (0, 1)]
        return runs + [process(svc(P), [req(P, 0), preq(P, 3), req(P, 1)])]

    for name, ((r0,), (r1,), out) in both(scenario).items():
        grid0, place, grid1 = out
        assert all(r.ok for r in out)
        assert place.batch_rids == (place.rid,)
        assert place.report["kind"] == "placement"
        assert_reports_equal(grid0.report, r0.report)
        assert_reports_equal(grid1.report, r1.report)
        assert len(grid0.batch_rids) == 2 and len(grid1.batch_rids) == 2


def test_transient_placement_fault_demotes_and_recovers():
    def scenario(P):
        P.faults.install("placement", "backend", count=1)
        out = [process(svc(P), [preq(P, 0, replay_dtype="float32")])]
        P.faults.reset()
        return out + [process(svc(P), [preq(P, 0, replay_dtype="float32")])]

    for name, ((res,), (clean,)) in both(scenario).items():
        assert res.ok and res.retries == 1
        assert res.policy["demotions"] == 1
        assert clean.policy["demotions"] == 0
        same_value(res.report, clean.report)


def test_hard_placement_fault_structured_and_quarantined():
    def scenario(P):
        P.faults.install("placement", "backend")
        service = svc(P)
        out = [process(service, [preq(P, 7, max_retries=1)])]
        P.faults.reset()
        out.append(process(service, [preq(P, 7)]))
        return out + [process(svc(P), [preq(P, 7)])]

    for name, ((res,), (again,), (fresh,)) in both(scenario).items():
        assert not res.ok
        e = res.error
        assert e["code"] == "replay-error" and e["stage"] == "placement"
        assert set(e) == {"code", "stage", "message", "retries"}
        assert not again.ok and again.error["code"] == "quarantined"
        assert fresh.ok


def test_placement_deadline_checked_between_retries(pkg):
    pkg.faults.install("placement", "backend")
    t0 = time.monotonic()
    (res,) = svc(pkg, backoff_s=0.05).process(
        [preq(pkg, 0, deadline_s=0.2, max_retries=1000)])
    assert not res.ok
    assert res.error["code"] == "deadline"
    assert res.error["stage"] == "placement"
    assert time.monotonic() - t0 < 30.0


def test_placement_request_validation(pkg):
    g, _ = placement_trace(pkg, 0)
    A = pkg.serve.AnalysisRequest
    with pytest.raises(ValueError, match="local_budget"):
        A(trace=g, kind="placement")
    with pytest.raises(ValueError, match="placement_method"):
        A(trace=g, kind="placement", local_budget=0,
          placement_method="magic")
    with pytest.raises(ValueError, match="kind"):
        A(trace=g, kind="disaggregate")


def test_placement_result_persisted_as_valid_json(tmp_path):
    def scenario(P):
        out_dir = tmp_path / P.name
        return [process(svc(P, results_dir=out_dir), [preq(P, 0)])]

    docs = {}
    for name, ((res,),) in both(scenario).items():
        assert res.ok and res.stored is True
        (f,) = sorted((tmp_path / name).glob("result_*.json"))
        doc = json.loads(f.read_text())
        assert doc["rid"] == res.rid
        assert doc["report"]["kind"] == "placement"
        assert doc["report"]["makespan"] == res.report["makespan"]
        assert doc["report"]["curve"] == \
            np.asarray(res.report["curve"]).tolist()
        docs[name] = doc
    # the same JSON, but the policy's backend names
    for doc in docs.values():
        doc.pop("policy")
    assert docs["repro"] == docs["repro_torch"]


# ------------------------------------------------------ background admission

def test_background_submit_and_run(pkg):
    service = pkg.serve.AnalysisService(batch_window_s=0.01, backoff_s=0.0)
    try:
        out = service.run([req(pkg, 0), req(pkg, 1)], timeout=120.0)
        assert all(r.ok for r in out)
        assert out[0].rid != out[1].rid
    finally:
        service.close()
    assert not service._thread.is_alive()
    with pytest.raises(RuntimeError):
        service.submit(req(pkg, 2))
    (solo,) = svc(REF).process([req(REF, 0)])
    assert_reports_equal(out[0].report, solo.report)


def test_close_drains_pending(pkg):
    service = pkg.serve.AnalysisService(batch_window_s=0.05, backoff_s=0.0)
    tickets = [service.submit(req(pkg, s)) for s in (0, 1)]
    service.close()
    for t in tickets:
        assert t.event.wait(60.0)
        assert t.result is not None and t.result.ok


# ------------------------------------------------------------- result store

def test_results_persisted_as_valid_json(tmp_path):
    def scenario(P):
        return [process(svc(P, results_dir=tmp_path / P.name), [req(P, 0)])]

    docs = {}
    for name, ((res,),) in both(scenario).items():
        assert res.ok and res.stored is True
        (f,) = sorted((tmp_path / name).glob("result_*.json"))
        doc = json.loads(f.read_text())
        assert doc["rid"] == res.rid
        assert doc["report"]["simulated"] == \
            np.asarray(res.report["simulated"]).tolist()
        docs[name] = doc
    assert sorted(docs["repro"]) == sorted(docs["repro_torch"])
    assert sorted(docs["repro"]["policy"]) == \
        sorted(docs["repro_torch"]["policy"])
    for doc in docs.values():
        doc.pop("policy")
    assert docs["repro"] == docs["repro_torch"]


def test_store_failure_degrades_not_fails(tmp_path):
    def scenario(P):
        P.faults.install("store", "io")
        return [process(svc(P, results_dir=tmp_path / P.name),
                        [req(P, 0)])]

    for name, ((res,),) in both(scenario).items():
        assert res.ok and res.stored is False
        assert res.report is not None
        assert list((tmp_path / name).glob("*.json")) == []


# ------------------------------------------- ambient (CI-forced) fault smoke

def test_service_survives_ambient_faults(monkeypatch):
    """Recurring transients at every stage, from the environment: every
    request recovers within the default budgets, in both packages."""
    spec = ("load:io:every=5,replay:backend:every=4,store:io:every=3,"
            "replay:latency:every=7:delay=0.005")

    def scenario(P):
        monkeypatch.setenv("EDAN_FAULTS", spec)
        P.faults.reset()
        service = P.serve.AnalysisService(start=False, backoff_s=0.001)
        runs = [process(service, [req(P, s, deadline_s=300.0,
                                      replay_dtype="float32")
                                  for s in (0, 1, 2)])]
        for s in (0, 1):
            runs.append(process(service, [req(P, s, deadline_s=300.0,
                                              replay_dtype="float32")]))
        for s in (0, 1):
            runs.append(process(service, [preq(P, s, deadline_s=300.0,
                                               replay_dtype="float32")]))
        assert sum(P.faults.fire_log.values()) > 0
        monkeypatch.delenv("EDAN_FAULTS")
        return runs

    for name, runs in both(scenario).items():
        for out in runs:
            assert all(r.ok for r in out), [r.error for r in out]


def test_crash_mid_result_write_leaves_nothing_or_valid(pkg, tmp_path):
    out_dir = tmp_path / "results"
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import os, sys, time\n"
         f"sys.path.insert(0, {SRC!r})\n"
         "real_replace = os.replace\n"
         "def slow_replace(a, b):\n"
         "    print('REPLACING', flush=True)\n"
         "    time.sleep(30)\n"
         "    real_replace(a, b)\n"
         f"from {pkg.name}.core import EDag\n"
         f"from {pkg.name}.serve import AnalysisService, AnalysisRequest\n"
         "g = EDag()\n"
         "prev = None\n"
         "for i in range(12):\n"
         "    v = g.add_vertex(is_mem=(i % 2 == 0))\n"
         "    if prev is not None:\n"
         "        g.add_edge(prev, v)\n"
         "    prev = v\n"
         f"svc = AnalysisService(start=False, results_dir={str(out_dir)!r})\n"
         "os.replace = slow_replace\n"
         "svc.process([AnalysisRequest(trace=g, alphas=(100.0,), "
         f"backend={pkg.backend!r})])\n"],
        env=dict(os.environ), stdout=subprocess.PIPE, text=True)
    line = child.stdout.readline().strip()
    assert line == "REPLACING", line
    os.kill(child.pid, signal.SIGKILL)
    child.wait(timeout=30)
    assert list(out_dir.glob("result_*.json")) == []
    (res,) = svc(pkg, results_dir=out_dir).process([req(pkg, 0)])
    assert res.ok and res.stored is True
    (kept,) = sorted(out_dir.glob("result_*.json"))
    json.loads(kept.read_text())


# ----------------------------------------------- the cache under the service

def test_cache_fault_quarantines_and_rerecords(monkeypatch):
    """A ``cache`` fault corrupts the newest persisted schedule; the next
    request's load quarantines it, re-records and answers exactly."""
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MIN", "0")

    def scenario(P):
        P.core.schedule_cache.clear()
        runs = [process(svc(P), [req(P, 0)])]
        P.core.schedule_cache.reset_stats()
        P.faults.install("cache-load", "cache", count=1)
        runs.append(process(svc(P), [req(P, 0)]))
        st = dict(P.core.schedule_cache.stats)
        # the fault fires at m=2's load and corrupts the newest entry,
        # m=4's, which that pair's load then quarantines and re-records
        assert (st["disk_hits"], st["quarantined"], st["record_runs"],
                st["stores"]) == (1, 1, 1, 1), st
        assert P.faults.fire_log[("cache-load", "cache")] == 1
        return runs

    for name, ((clean,), (res,)) in both(scenario).items():
        assert res.ok and res.retries == 0
        assert_reports_equal(res.report, clean.report)


def test_union_batches_reuse_the_members_disk_entries(monkeypatch):
    """A warm service (fresh objects, the same cache directory) records
    no schedule: the union's members load theirs from disk."""
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MIN", "0")

    def scenario(P):
        P.core.schedule_cache.clear()
        runs = [process(svc(P), [req(P, s) for s in (0, 1, 2)])]
        P.core.schedule_cache.reset_stats()
        runs.append(process(svc(P), [req(P, s) for s in (0, 1, 2)]))
        st = P.core.schedule_cache.stats
        assert st["record_runs"] == 0 and st["disk_hits"] == 3 * 2
        return runs

    for name, (cold, warm) in both(scenario).items():
        for a, b in zip(cold, warm):
            assert_reports_equal(a.report, b.report)


# ------------------------------------------------------------ service knobs

BAD_NUMERIC = ["", "  ", "abc", "-5"]


@pytest.mark.parametrize("val", BAD_NUMERIC)
def test_deadline_env_falls_back(pkg, monkeypatch, val):
    monkeypatch.setenv("EDAN_DEADLINE_S", val)
    assert pkg.serve.default_deadline_s() == \
        pkg.analysis.DEFAULT_DEADLINE_S


def test_deadline_env_valid_zero_and_inf(pkg, monkeypatch):
    d = pkg.analysis.DEFAULT_DEADLINE_S
    monkeypatch.setenv("EDAN_DEADLINE_S", "2.5")
    assert pkg.serve.default_deadline_s() == 2.5
    monkeypatch.setenv("EDAN_DEADLINE_S", "0")
    assert pkg.serve.default_deadline_s() == d
    monkeypatch.setenv("EDAN_DEADLINE_S", "inf")
    assert pkg.serve.default_deadline_s() == d


@pytest.mark.parametrize("val", BAD_NUMERIC)
def test_max_retries_env_falls_back(pkg, monkeypatch, val):
    monkeypatch.setenv("EDAN_MAX_RETRIES", val)
    assert pkg.serve.default_max_retries() == \
        pkg.analysis.DEFAULT_MAX_RETRIES


def test_max_retries_env_zero_is_valid(pkg, monkeypatch):
    monkeypatch.setenv("EDAN_MAX_RETRIES", "0")
    assert pkg.serve.default_max_retries() == 0
    monkeypatch.setenv("EDAN_MAX_RETRIES", "5")
    assert pkg.serve.default_max_retries() == 5


def test_faults_env_typo_raises_with_choices(pkg, monkeypatch):
    f = pkg.faults
    monkeypatch.setenv("EDAN_FAULTS", "reply:io")
    with pytest.raises(ValueError) as ei:
        f.check("load")
    assert "replay" in str(ei.value) and "EDAN_FAULTS" in str(ei.value)
    monkeypatch.setenv("EDAN_FAULTS", "load:oi")
    with pytest.raises(ValueError) as ei:
        f.check("load")
    assert "io" in str(ei.value) and "backend" in str(ei.value)
    monkeypatch.setenv("EDAN_FAULTS", "load:io:conut=1")
    with pytest.raises(ValueError) as ei:
        f.check("load")
    assert "count" in str(ei.value)


def test_faults_env_empty_means_disarmed(pkg, monkeypatch):
    monkeypatch.setenv("EDAN_FAULTS", "   ")
    pkg.faults.check("load")
    assert pkg.faults.active() == []


# ------------------------------------------------------------- the ladder

@pytest.mark.parametrize("backend,dtype,want", [
    ("cpu", None, [("cpu", "float64")]),
    ("cpu", "float64", [("cpu", "float64")]),
    ("cpu", "float32", [("cpu", "float32"), ("cpu", "float64")]),
    (None, None, [("cpu", "float64")]),
])
def test_ladder_resolves_rungs_before_dropping_equal_ones(backend, dtype,
                                                          want):
    got = T.ExecPolicy.resolve(backend=backend, replay_dtype=dtype).ladder()
    assert [(p.backend, p.replay_dtype) for p in got] == want
    assert all(p.mem_budget == got[0].mem_budget for p in got)


def test_ladder_without_a_card_keeps_the_request(monkeypatch):
    """A ``cuda`` request on a host without a card keeps its rungs as
    given (they raise again at dispatch; no dtype named stays None) and
    ends on ``("cpu", "float64")``: the only rung that names the host is
    the last."""
    if T.backend.torch.cuda.is_available():
        pytest.skip("this host has a card")
    got = T.ExecPolicy.resolve(backend="cuda").ladder()
    assert [(p.backend, p.replay_dtype) for p in got] == \
        [("cuda", None), ("cuda", "float64"), ("cpu", "float64")]


@pytest.mark.parametrize("env,dtype,rung0", [
    ({}, None, None),
    ({"EDAN_X64": "0"}, None, None),
    ({"EDAN_REPLAY_DTYPE": "float32"}, None, "float32"),
    ({}, "float32", "float32"),
    ({"EDAN_X64": "1"}, None, "float64"),
])
def test_ladder_on_the_card_names_only_a_named_dtype(monkeypatch, env,
                                                     dtype, rung0):
    """On the card rung 0 carries the dtype an argument or variable
    names, and None where none does (the dispatch's default, one float64
    pass); a named float64 collapses into the demotion rung."""
    monkeypatch.setattr(T.backend, "select_backend",
                        lambda override=None: "cuda")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = T.ExecPolicy.resolve(replay_dtype=dtype).ladder()
    want = [("cuda", rung0), ("cuda", "float64"), ("cpu", "float64")]
    assert [(p.backend, p.replay_dtype) for p in got] == \
        (want[1:] if rung0 == "float64" else want)


# ---------------------------------------------------------- the fault layer

def test_parse_spec_basic(pkg):
    f = pkg.faults
    (s,) = f.parse_spec("replay:backend:every=3")
    assert (s.stage, s.kind, s.every) == ("replay", "backend", 3)
    a, b = f.parse_spec("load:io:count=1, store:latency:delay=0.25:rid=7")
    assert (a.stage, a.kind, a.count) == ("load", "io", 1)
    assert (b.stage, b.kind, b.delay, b.rid) == ("store", "latency",
                                                 0.25, 7)
    assert f.parse_spec("") == []
    assert f.parse_spec(" , ,") == []


def test_stages_kinds_and_params_are_the_references():
    assert TS.faults.STAGES == RS.faults.STAGES
    assert TS.faults.KINDS == RS.faults.KINDS
    assert TS.faults._PARAMS == RS.faults._PARAMS


def test_parse_spec_typos_raise_with_choices(pkg):
    f = pkg.faults
    for text in ("reply:backend", "replay:backnd", "replay:backend:evry=3",
                 "replay", "replay:backend:every",
                 "replay:backend:every=x"):
        with pytest.raises(ValueError) as ei:
            f.parse_spec(text)
        with pytest.raises(ValueError) as ej:
            RS.faults.parse_spec(text)
        assert str(ei.value) == str(ej.value)


def test_install_validates_like_parse(pkg):
    f = pkg.faults
    with pytest.raises(ValueError):
        f.install("reply", "backend")
    with pytest.raises(ValueError):
        f.install("replay", "backnd")
    with pytest.raises(ValueError):
        f.install("replay", "backend", evry=3)


def test_count_fires_first_n_then_stops(pkg):
    f = pkg.faults
    f.install("load", "io", count=2)
    for _ in range(2):
        with pytest.raises(f.InjectedIOError):
            f.check("load")
    for _ in range(10):
        f.check("load")


def test_every_fires_deterministically(pkg):
    f = pkg.faults
    f.install("replay", "backend", every=3)
    fired = []
    for _ in range(9):
        try:
            f.check("replay")
            fired.append(False)
        except f.InjectedBackendError:
            fired.append(True)
    assert fired == [False, False, True] * 3


def test_unbounded_spec_is_a_hard_fault(pkg):
    f = pkg.faults
    f.install("report", "io")
    for _ in range(5):
        with pytest.raises(f.InjectedIOError):
            f.check("report")


def test_rid_and_min_batch_restrictions(pkg):
    f = pkg.faults
    f.install("replay", "backend", rid=3)
    f.check("replay")
    f.check("replay", rid=2)
    with pytest.raises(f.InjectedBackendError):
        f.check("replay", rid=3)
    f.reset()
    f.install("replay", "backend", min_batch=2)
    f.check("replay", batch=1)
    with pytest.raises(f.InjectedBackendError):
        f.check("replay", batch=2)


def test_latency_sleeps_and_returns(pkg):
    pkg.faults.install("load", "latency", delay=0.05)
    t0 = time.monotonic()
    pkg.faults.check("load")
    assert time.monotonic() - t0 >= 0.04


def test_placement_stage_in_matrix(pkg):
    f = pkg.faults
    assert "placement" in f.STAGES
    (s,) = f.parse_spec("placement:backend:every=2")
    assert (s.stage, s.kind, s.every) == ("placement", "backend", 2)
    f.install("placement", "backend", count=1)
    with pytest.raises(f.InjectedBackendError):
        f.check("placement")
    f.check("placement")
    assert f.fire_log[("placement", "backend")] == 1
    f.reset()
    f.install("placement", "io", rid=5)
    f.check("placement", rid=4)
    with pytest.raises(f.InjectedIOError):
        f.check("placement", rid=5)


def test_env_spec_armed_and_reparsed_on_change(pkg, monkeypatch):
    f = pkg.faults
    monkeypatch.setenv("EDAN_FAULTS", "load:io")
    with pytest.raises(f.InjectedIOError):
        f.check("load")
    monkeypatch.setenv("EDAN_FAULTS", "")
    f.check("load")
    monkeypatch.setenv("EDAN_FAULTS", "finalize:backend:count=1")
    with pytest.raises(f.InjectedBackendError):
        f.check("finalize")
    f.check("finalize")


def test_env_typo_raises_at_check(pkg, monkeypatch):
    monkeypatch.setenv("EDAN_FAULTS", "reply:io")
    with pytest.raises(ValueError) as ei:
        pkg.faults.check("load")
    assert "reply" in str(ei.value)


def test_core_hooks_attach_only_while_needed(pkg):
    f, core = pkg.faults, pkg.core
    bk, sc = core.backend, core.schedule_cache
    assert bk.fault_hook is None and sc.fault_hook is None
    f.install("kernel", "backend")
    assert bk.fault_hook is not None and sc.fault_hook is None
    f.reset()
    assert bk.fault_hook is None
    f.install("cache-load", "io")
    assert sc.fault_hook is not None and bk.fault_hook is None
    f.reset()
    assert sc.fault_hook is None


def test_cache_store_hook_fires_inside_schedule_cache(pkg, tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", str(tmp_path))
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MIN", "0")
    pkg.faults.install("cache-store", "io")
    assert not pkg.core.schedule_cache.store(
        "d" * 64, 4, 0, 4, 1.0, np.arange(4, dtype=np.int64),
        np.arange(4, dtype=np.int64), np.zeros(0, dtype=np.int64),
        np.zeros(4, dtype=np.int64))
    assert pkg.faults.fire_log[("cache-store", "io")] == 1
    assert list(tmp_path.iterdir()) == []


def test_fire_log_counts(pkg):
    f = pkg.faults
    f.install("load", "io", every=2)
    for _ in range(4):
        try:
            f.check("load")
        except f.InjectedIOError:
            pass
    assert f.fire_log[("load", "io")] == 2


def test_kernel_hook_raises_the_injected_error():
    """The hook the ``kernel`` stage attaches to the port's dispatch
    raises the injected error on its schedule; the dispatch lets it
    through on the card (``test_torch_gpu.py::test_fault_hook_propagates``
    and ``::test_kernel_fault_demotes_visibly``)."""
    PORT.faults.install("kernel", "backend", count=1)
    with pytest.raises(PORT.faults.InjectedBackendError):
        tbk.fault_hook()
    tbk.fault_hook()                      # the transient is over
    assert PORT.faults.fire_log[("kernel", "backend")] == 1
    assert tsc.fault_hook is None
