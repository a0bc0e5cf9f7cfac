"""The harness on the program's CPU path at a test's size: a run end to
end, cells and metrics found by name, the modules a run loads, and the
comparison refusing the control and a broken timed path."""
import json
import subprocess
import sys

import numpy as np
import pytest

from edanbench import harness
from edanbench.conftest import ROOT

CELLS = ["polybench15-n20.suite", "hpcg-16x6.sweep"]
#: the alpha axis of the sweep cell's traffic
SWEEP_GRID = np.asarray(json.loads(
    (ROOT / "edanbench" / "traffic" / "sweep.json").read_text())
    ["grid"]["alphas"], dtype=float)
SWEEP_ALPHAS = len(SWEEP_GRID)


def run(root, cell, seconds=0.2, seed=2 ** 31 + 5):
    return harness.run_cell(cell, seed, seconds, False, root=root,
                            device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_correct_on_the_cpu(small_root, cpu_env, cell):
    out = run(small_root, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert "setup_s" in out["metrics"]
    assert list(out)[-1] == "checks"
    assert out["checks"]["wrong"] == {"value": 0, "limit": 0}


def test_a_new_cell_and_metric_are_found_by_name(small_root, cpu_env):
    spec = json.loads((small_root / "BENCHMARK.json").read_text())
    (small_root / "edanbench" / "traffic" / "tiny.json").write_text(
        json.dumps({"driver": "sweep_grid", "grid": {
            "alphas": [60, 90], "ms": [2], "compute_slots": [0]},
            "check": {"points": 2}}))
    (small_root / "edanbench" / "metrics" / "steps_seen.py").write_text(
        "def read(run):\n    return run.win['steps']\n")
    spec["workloads"].append({"name": "hpcg-16x6.tiny", "config":
                              "hpcg-16x6", "traffic": "tiny", "chips": 1,
                              "why": "throwaway"})
    spec["end_to_end"].append({"name": "steps_seen", "unit": "count",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["hpcg-16x6.tiny"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run(small_root, "hpcg-16x6.tiny")
    assert out["correct"]
    assert out["metrics"]["steps_seen"]["value"] >= 1
    assert "points_per_s" not in out["metrics"]


def _modules(code: str, cwd) -> set:
    p = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.splitlines()[-1]))


def test_no_jax_in_a_run_or_the_reference(small_root):
    head = (f"import sys, json\nsys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT)!r}]\n")
    tail = ("\nprint(json.dumps(sorted({n.split('.')[0] "
            "for n in sys.modules})))\n")
    ran = _modules(head + (
        "from pathlib import Path\nfrom edanbench import harness\n"
        "for c in ('polybench15-n20.suite', 'hpcg-16x6.sweep'):\n"
        f"    harness.run_cell(c, 3, 0.1, False, root=Path({str(small_root)!r}),"
        " device='cpu')\n") + tail, small_root)
    ref = _modules(head + (
        "from edanbench.reference import machine, polybench, hpcg_cg\n"
        "machine.makespan(polybench.trace_one('lu', 4, 1), 2, 50.0)\n"
        "hpcg_cg.trace_cg(3, 1, 1)\n") + tail, small_root)
    assert "repro_torch" in ran and "edanbench" in ran
    for bad in harness.FORBIDDEN:
        assert bad not in ran and bad not in ref
    assert "repro_torch" not in ref and "torch" not in ref


def test_names_are_compared_whole(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", sys)
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "flax.lookalike", sys)
    assert "flax" in harness.forbidden_modules()


def _alter(out):
    return out + 1.0


def _halve(out):
    out = out.copy()
    out[:, ::2] = 0.0
    return out


def _halve_1d(out):
    out = out.copy()
    out[::2] = 0.0
    return out


@pytest.mark.parametrize("fault", ["answer altered", "half left out"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(small_root, cpu_env,
                                            monkeypatch, cell, fault):
    from repro_torch.core import scheduler, suite

    def wrap(mod, name, fn):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, **k: fn(orig(*a, **k)))

    if fault == "answer altered":
        wrap(suite, "_suite_grid_batch", _alter)
        wrap(scheduler, "_batch_uniq", _alter)
    else:
        wrap(suite, "_suite_grid_batch", _halve)
        wrap(scheduler, "_batch_uniq", _halve_1d)
    out = run(small_root, cell)
    assert not out["correct"]
    assert out["checks"]["wrong"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_refused(small_root, cpu_env, cell):
    """The reference in float32, in the program's place, fails the limits
    (the HPCG traffic gets alphas that float32 cannot hold at this size)."""
    if cell.startswith("hpcg"):
        p = small_root / "edanbench" / "traffic" / "sweep.json"
        tr = json.loads(p.read_text())
        tr["grid"]["alphas"] = list(np.linspace(50, 300, 13))
        p.write_text(json.dumps(tr))
    from edanbench.control import readings
    got = readings(cell, 9, 0.1, root=small_root, device="cpu")
    assert got["program"]["wrong"] == 0
    reading = got["control"]
    assert reading["wrong"] > harness.LIMITS["wrong"]
    assert reading["max_rel_gap"] > harness.LIMITS["max_rel_gap"]


@pytest.mark.parametrize("alpha", range(SWEEP_ALPHAS))
def test_one_wrong_alpha_of_the_sweep_is_not_correct(small_root, cpu_env,
                                                     monkeypatch, alpha):
    """Every alpha of a sweep step is compared, the one that the memoised
    plan answers among them, whatever the seed draws."""
    from repro_torch.core import scheduler
    orig = scheduler._batch_uniq

    def one_off(g, alphas, *a, **k):
        out = orig(g, alphas, *a, **k).copy()
        hit = np.flatnonzero(alphas == SWEEP_GRID[alpha])
        out[hit] += 1.0
        return out
    monkeypatch.setattr(scheduler, "_batch_uniq", one_off)
    out = run(small_root, "hpcg-16x6.sweep")
    assert not out["correct"]
    assert out["checks"]["wrong"]["value"] > 0


def test_the_reference_in_worker_processes_equals_in_process():
    from edanbench import check
    cfg = {"tracer": "hpcg_cg", "n": 3, "iters": 1, "unit": 1.0}
    grid = {"alphas": [50.0, 300.0], "ms": [2, 4], "compute_slots": [0, 8]}
    pts = [("cg", a, m, s) for a in (0, 1) for m in (0, 1) for s in (0, 1)]
    precs = ("float64", "float32")
    assert check.reference_values(cfg, 4, pts, grid, precs, workers=2) == \
        check.reference_values(cfg, 4, pts, grid, precs)
    assert check.workers_for(check.PARALLEL_VERTICES - 1) == 1


def test_every_metric_is_read_where_its_end_to_end_metric_is():
    """Each metric has its reader by name, and each per-layer metric is
    listed only in cells that report the end-to-end metric it moves."""
    spec = harness.load_spec(ROOT)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (ROOT / "edanbench" / "metrics" / f"{m['name']}.py").exists()
    for c in spec["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(spec, c["name"],
                                                      False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = harness.cell_metrics(spec, c["name"], True)
        assert per and all(m["moves"] in e2e for m in per)


def test_device_time_per_point_reads_the_profiled_window():
    from types import SimpleNamespace
    from edanbench.readers import device_ms_per_point
    run = SimpleNamespace(seg={"busy_s": 11.0, "window_s": 100.0},
                          win={"points": 11, "elapsed_s": 100.0})
    assert device_ms_per_point(run) == 1000.0
    assert device_ms_per_point(SimpleNamespace(seg=None, win={})) is None
    run.seg["busy_s"] = None
    assert device_ms_per_point(run) is None
