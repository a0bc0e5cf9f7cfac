"""The port's persistence layer (``repro_torch.core.schedule_cache``,
``repro_torch.core.trace_store``, the scheduler's and the suite's disk
tier, ``EDag(legacy_build=...)``) against the JAX package's, on the CPU.

The cases of ``tests/test_schedule_cache.py``, ``tests/test_streaming.py``
and the cache and trace-store cases of ``tests/test_env_hardening.py``,
each run through both packages (``pkg``): every makespan is held bit for
bit to the reference package's ``simulate_reference`` on the same trace.
Then round trips across the packages in both directions — format-3 and
format-4 schedule-cache entries and format-1 trace stores written by one
package and loaded by the other — with the stored bytes compared member
by member.  Every test that touches a cache or a store points its
variable at ``tmp_path``.
"""
import json
import os
import shutil
import subprocess
import sys
import warnings
import zipfile
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, strategies as st

import repro.core as R
import repro_torch.core as T
from repro.apps import polybench as rpoly
from repro.core import graph as rgraph
from repro.core import plan as rplan
from repro.core import scheduler as rsched
from repro.core import trace_store as rstore
from repro_torch.apps import polybench as tpoly
from repro_torch.core import graph as tgraph
from repro_torch.core import plan as tplan
from repro_torch.core import scheduler as tsched
from repro_torch.core import trace_store as tstore

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

PKGS = {
    "repro": SimpleNamespace(
        name="repro", core=R, sc=R.schedule_cache, sched=rsched,
        graph=rgraph, plan=rplan, store=rstore, poly=rpoly),
    "repro_torch": SimpleNamespace(
        name="repro_torch", core=T, sc=T.schedule_cache, sched=tsched,
        graph=tgraph, plan=tplan, store=tstore, poly=tpoly),
}


@pytest.fixture(autouse=True)
def cpu_env(monkeypatch):
    """The port on the host; no ambient cache, policy or build knobs."""
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")
    for knob in ("EDAN_X64", "EDAN_REPLAY_DTYPE", "EDAN_BACKEND",
                 "EDAN_REPLAY_MEM_BUDGET", "EDAN_SCHEDULE_CACHE_MIN",
                 "EDAN_SCHEDULE_CACHE_MAX", "EDAN_SCHEDULE_CACHE_MMAP_MIN",
                 "EDAN_LEGACY_BUILD", "EDAN_TRACE_STORE"):
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def cache_env(tmp_path, monkeypatch):
    """Redirect the schedule cache to a private tmp dir, no size floor."""
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", str(tmp_path))
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MIN", "0")
    for P in PKGS.values():
        P.sc.reset_stats()
    return tmp_path


@pytest.fixture
def mmap_env(cache_env, monkeypatch):
    """Force every entry onto the format-4 directory layout."""
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MMAP_MIN", "0")
    return cache_env


def build_graph(P, seed: int = 0, n: int = 60, p_edge: float = 0.1,
                label: str = ""):
    rng = np.random.default_rng(seed)
    g = P.core.EDag()
    for i in range(n):
        g.add_vertex(is_mem=bool(rng.random() < 0.5), nbytes=8.0,
                     label=label)
        for j in range(i):
            if rng.random() < p_edge:
                g.add_edge(j, i)
    g._finalize()
    return g


def want(seed: int, alphas, n: int = 60, **kw) -> np.ndarray:
    """The reference package's heapq makespans on ``build_graph(seed)``."""
    g = build_graph(PKGS["repro"], seed=seed, n=n)
    return np.array([R.simulate_reference(g, alpha=a, **kw)
                     for a in alphas])


def bits(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


def schedule_arrays(g):
    n = g.n_vertices
    return (np.arange(n, dtype=np.int64),
            np.flatnonzero(g.is_mem).astype(np.int64),
            np.zeros(0, dtype=np.int64), np.zeros(n, dtype=np.int64))


# ------------------------------------------------------------------ digests

def test_trace_digest_deterministic_across_objects(pkg):
    assert build_graph(pkg).trace_digest() == build_graph(pkg).trace_digest()
    assert build_graph(pkg).trace_digest() == \
        build_graph(PKGS["repro"]).trace_digest()


def test_trace_digest_ignores_costs_and_labels(pkg):
    a = build_graph(pkg, label="x")
    b = build_graph(pkg, label="y")
    assert a.trace_digest() == b.trace_digest()
    c = pkg.core.EDag()
    d = pkg.core.EDag()
    c.add_vertex(cost=1.0, is_mem=True)
    d.add_vertex(cost=7.0, is_mem=True, nbytes=64.0)
    assert c.trace_digest() == d.trace_digest()


def test_trace_digest_changes_on_mutation(pkg):
    g = build_graph(pkg)
    d0 = g.trace_digest()
    g.add_vertex(is_mem=False)
    d1 = g.trace_digest()
    assert d1 != d0
    g.add_edge(0, g.n_vertices - 1)
    d2 = g.trace_digest()
    assert d2 != d1
    h = pkg.core.EDag()
    h.add_vertex(is_mem=True)
    k = pkg.core.EDag()
    k.add_vertex(is_mem=False)
    assert h.trace_digest() != k.trace_digest()


# ------------------------------------------------------------ store / load

def test_store_load_roundtrip(pkg, cache_env):
    sc = pkg.sc
    g = build_graph(pkg)
    topo, O_mem, O_alu, level = schedule_arrays(g)
    assert sc.store(g.trace_digest(), 4, 0, g.n_vertices, 1.0,
                    topo, O_mem, O_alu, level)
    got = sc.load(g.trace_digest(), 4, 0, g.n_vertices, 1.0)
    assert got is not None
    t, om, oa, lv = got
    assert np.array_equal(t, topo) and np.array_equal(om, O_mem)
    assert np.array_equal(oa, O_alu) and np.array_equal(lv, level)
    assert sc.load(g.trace_digest(), 3, 0, g.n_vertices, 1.0) is None
    assert sc.load(g.trace_digest(), 4, 1, g.n_vertices, 1.0) is None
    assert sc.load(g.trace_digest(), 4, 0, g.n_vertices, 2.0) is None
    assert sc.load(g.trace_digest(), 4, 0, g.n_vertices + 1, 1.0) is None


def test_delta_encoding_roundtrip_nonmonotone(pkg, cache_env):
    sc = pkg.sc
    g = build_graph(pkg, seed=5)
    n = g.n_vertices
    rng = np.random.default_rng(0)
    topo = rng.permutation(n).astype(np.int64)
    O_mem = rng.permutation(np.flatnonzero(g.is_mem)).astype(np.int64)
    O_alu = rng.permutation(np.flatnonzero(~g.is_mem)).astype(np.int64)
    level = rng.integers(0, n, size=n).astype(np.int64)
    assert sc.store(g.trace_digest(), 4, 2, n, 1.0, topo, O_mem, O_alu,
                    level)
    got = sc.load(g.trace_digest(), 4, 2, n, 1.0)
    assert got is not None
    for w, have in zip((topo, O_mem, O_alu, level), got):
        assert have.dtype == np.int32 and np.array_equal(w, have)
    (entry,) = list(cache_env.glob("*.npz"))
    with np.load(entry) as z:
        assert int(z["format"]) == 3
        for key in sc._ARRAY_KEYS:
            assert z[key].dtype == np.int32


def test_store_refuses_unencodable_arrays(pkg, cache_env):
    sc = pkg.sc
    g = build_graph(pkg)
    n = g.n_vertices
    topo, O_mem, O_alu, ok_level = schedule_arrays(g)
    bad = [
        dict(level=np.arange(n, dtype=np.int64) - 10 ** 6),
        dict(level=np.arange(n, dtype=np.int64) * 2 ** 40),
        dict(level=np.stack([ok_level, ok_level])),
        dict(topo=topo.astype(np.int64) + 2 ** 31),
    ]
    for kw in bad:
        args = dict(topo=topo, O_mem=O_mem, O_alu=O_alu, level=ok_level)
        args.update(kw)
        assert not sc.store(g.trace_digest(), 4, 0, n, 1.0, **args)
    assert list(cache_env.glob("*.npz")) == []


def _plant_format2(sc, d, g):
    n = g.n_vertices
    path = sc._entry_path(d, g.trace_digest(), 4, 0, 1.0)
    np.savez_compressed(
        path, format=2, digest=g.trace_digest(), n=n, unit=1.0, m=4,
        compute_slots=0, topo=np.arange(n, dtype=np.int64),
        O_mem=np.flatnonzero(g.is_mem).astype(np.int64),
        O_alu=np.zeros(0, dtype=np.int64),
        level=np.zeros(n, dtype=np.int64))
    return path


def test_old_format_entry_rejected_and_rerecorded(pkg, cache_env):
    sc = pkg.sc
    g = build_graph(pkg, seed=7)
    alphas = [50.0, 100.0, 200.0]
    _plant_format2(sc, cache_env, g)
    assert sc.load(g.trace_digest(), 4, 0, g.n_vertices, 1.0) is None
    sc.reset_stats()
    assert bits(pkg.core.latency_sweep(build_graph(pkg, seed=7), alphas),
                want(7, alphas))
    assert sc.stats["record_runs"] == 1


def test_wrong_dtype_delta_arrays_rejected(pkg, cache_env):
    sc = pkg.sc
    g = build_graph(pkg, seed=12)
    n = g.n_vertices
    assert sc.store(g.trace_digest(), 4, 0, n, 1.0, *schedule_arrays(g))
    (entry,) = list(cache_env.glob("*.npz"))
    with np.load(entry) as z:
        fields = {k: z[k] for k in z.files}
    fields["topo_d"] = fields["topo_d"].astype(np.float64)
    np.savez_compressed(entry, **fields)
    assert sc.load(g.trace_digest(), 4, 0, n, 1.0) is None


def test_delta_encoding_compacts_entries(pkg, cache_env):
    sc = pkg.sc
    g = pkg.poly.trace_kernel("gemm", 10)
    pkg.core.latency_sweep(g, [50.0, 100.0, 200.0], m=4)
    (entry,) = list(cache_env.glob("*.npz"))
    new_size = entry.stat().st_size
    with np.load(entry) as z:
        arrays = {k: np.cumsum(z[k].astype(np.int64))
                  for k in sc._ARRAY_KEYS}
    old = cache_env / "old_format.npz"
    with open(old, "wb") as f:
        np.savez_compressed(f, **arrays)
    assert new_size < 0.5 * old.stat().st_size


def test_load_rejects_corrupt_entry(pkg, cache_env):
    sc = pkg.sc
    g = build_graph(pkg)
    sc.store(g.trace_digest(), 4, 0, g.n_vertices, 1.0, *schedule_arrays(g))
    (entry,) = list(cache_env.glob("*.npz"))
    entry.write_bytes(b"definitely not a zip archive")
    assert sc.load(g.trace_digest(), 4, 0, g.n_vertices, 1.0) is None


def test_disabled_and_threshold_write_nothing(pkg, cache_env, monkeypatch):
    g = build_graph(pkg)
    alphas = [50.0, 100.0, 200.0]
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")
    pkg.core.latency_sweep(g, alphas)
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", str(cache_env))
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MIN", "1000000")
    pkg.core.latency_sweep(build_graph(pkg, seed=1), alphas)
    assert list(cache_env.glob("*.npz")) == []


def test_prune_cap(pkg, cache_env, monkeypatch):
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MAX", "2")
    g = build_graph(pkg)
    pkg.core.sweep_grid(g, [50.0, 100.0, 200.0], ms=[1, 2, 3, 4],
                        compute_slots=[0])
    assert len(list(cache_env.glob("*.npz"))) <= 2
    assert pkg.sc.clear() >= 1
    assert list(cache_env.glob("*.npz")) == []


# ------------------------------------------------------- hits and validity

def test_disk_hit_skips_recording_and_stays_exact(pkg, cache_env):
    sc, sweep = pkg.sc, pkg.core.latency_sweep
    alphas = [50.0, 100.0, 150.0, 300.0]
    w = want(0, alphas, m=3, compute_slots=2)
    cold = sweep(build_graph(pkg), alphas, m=3, compute_slots=2)
    assert sc.stats["record_runs"] == 1 and sc.stats["stores"] == 1
    sc.reset_stats()
    g2 = build_graph(pkg)            # a fresh object: as a new process
    warm = sweep(g2, alphas, m=3, compute_slots=2)
    assert sc.stats["disk_hits"] == 1 and sc.stats["record_runs"] == 0
    assert bits(cold, w) and bits(warm, w)
    sc.reset_stats()
    assert bits(sweep(g2, alphas, m=3, compute_slots=2), w)
    assert sc.stats["memory_hits"] == 1 and sc.stats["disk_hits"] == 0
    assert sc.stats["record_runs"] == 0


def test_mutated_trace_misses_and_rerecords(pkg, cache_env):
    sc = pkg.sc
    alphas = [50.0, 100.0, 200.0]
    g = build_graph(pkg)
    pkg.core.latency_sweep(g, alphas)
    g.add_vertex(is_mem=True)
    sc.reset_stats()
    got = pkg.core.latency_sweep(g, alphas)
    assert sc.stats["misses"] == 1 and sc.stats["record_runs"] == 1
    r = build_graph(PKGS["repro"])
    r.add_vertex(is_mem=True)
    assert bits(got, np.array([R.simulate_reference(r, alpha=a)
                               for a in alphas]))


def test_wrong_machine_schedule_is_rejected_by_verification(pkg, cache_env):
    g = build_graph(pkg, seed=3)
    alphas = [50.0, 100.0, 200.0]
    _, topo, O_mem, O_alu = pkg.sched._event_loop(
        g.is_mem, g._sim_lists(), 1, 50.0, 1.0, 0, record=True)
    pkg.sc.store(g.trace_digest(), 4, 0, g.n_vertices, 1.0, topo, O_mem,
                 O_alu, np.zeros(g.n_vertices, dtype=np.int64))
    got = pkg.core.latency_sweep(build_graph(pkg, seed=3), alphas, m=4)
    assert bits(got, want(3, alphas, m=4))


def test_plan_from_cache_rejects_malformed_arrays(pkg):
    pfc = pkg.sched._plan_from_cache
    g = build_graph(pkg, seed=4)
    n = g.n_vertices
    topo = np.arange(n, dtype=np.int64)
    O_mem = np.flatnonzero(g.is_mem).astype(np.int64)
    O_alu = np.flatnonzero(~g.is_mem).astype(np.int64)
    assert pfc(g, 4, 2, topo, O_mem, O_alu, None) is not None
    bad = [
        (topo[:-1], O_mem, O_alu),
        (np.zeros(n, dtype=np.int64), O_mem, O_alu),
        (topo - 1, O_mem, O_alu),
        (topo, O_mem[::-1][1:], O_alu),
        (topo, O_alu[:len(O_mem)], O_alu),
        (topo, O_mem, O_alu[:-1]),
    ]
    for t, om, oa in bad:
        assert pfc(g, 4, 2, t, om, oa, None) is None
    assert pfc(g, 4, 0, topo, O_mem, O_alu, None) is None
    plan = pfc(g, 4, 2, topo, O_mem, O_alu, np.zeros(n, dtype=np.int64))
    assert plan is not None
    if g.n_edges:
        lv = plan.level_aug
        assert (lv[plan.rank[g.src]] < lv[plan.rank[g.dst]]).all()


def test_malformed_level_and_shape_entries_degrade_gracefully(pkg,
                                                              cache_env):
    g = build_graph(pkg, seed=6)
    n = g.n_vertices
    alphas = [50.0, 100.0, 200.0]
    w = want(6, alphas, m=4)
    topo, O_mem, O_alu, _ = schedule_arrays(g)
    digest = g.trace_digest()
    for lvl in (np.arange(n, dtype=np.int64) - 10 ** 6,
                np.arange(n, dtype=np.int64) * 2 ** 40,
                np.stack([np.arange(n)] * 2).astype(np.int64)):
        pkg.sc.store(digest, 4, 0, n, 1.0, topo, O_mem, O_alu, lvl)
        assert bits(pkg.core.latency_sweep(build_graph(pkg, seed=6), alphas,
                                           m=4), w)
    pkg.sc.store(digest, 4, 0, n, 1.0, np.stack([topo, topo]), O_mem, O_alu,
                 np.zeros(n, dtype=np.int64))
    assert bits(pkg.core.latency_sweep(build_graph(pkg, seed=6), alphas,
                                       m=4), w)


def test_memo_keyed_by_unit_and_stale_plan_replaced(pkg, cache_env):
    sc, sweep = pkg.sc, pkg.core.latency_sweep
    g = build_graph(pkg, seed=8)
    alphas = [50.0, 100.0, 200.0]
    sweep(g, alphas, m=4, unit=1.0)
    sc.reset_stats()
    w = want(8, alphas, m=4, unit=2.0)
    assert bits(sweep(g, alphas, m=4, unit=2.0), w)
    assert sc.stats["record_runs"] >= 1
    sc.reset_stats()
    assert bits(sweep(g, alphas, m=4, unit=2.0), w)
    assert sc.stats["record_runs"] == 0 and sc.stats["memory_hits"] == 1


def test_renamed_entry_rejected_by_stored_fields(pkg, cache_env):
    g = build_graph(pkg, seed=9)
    pkg.core.latency_sweep(g, [50.0, 100.0, 200.0], m=2)
    (entry,) = list(cache_env.glob("*.npz"))
    shutil.copy(entry, cache_env / entry.name.replace("_m2_", "_m4_"))
    assert pkg.sc.load(g.trace_digest(), 4, 0, g.n_vertices, 1.0) is None


def test_backward_slot_chain_rejected(pkg):
    g = pkg.core.EDag()
    for _ in range(3):
        g.add_vertex(is_mem=True)
    g._finalize()
    topo = np.arange(3, dtype=np.int64)
    empty = np.zeros(0, dtype=np.int64)
    pfc = pkg.sched._plan_from_cache
    assert pfc(g, 1, 0, topo, np.array([1, 0, 2], dtype=np.int64), empty,
               None) is None
    assert pfc(g, 1, 0, topo, np.array([0, 1, 2], dtype=np.int64), empty,
               None) is not None


def test_foreign_digest_entry_rejected(pkg, cache_env):
    g1 = build_graph(pkg, seed=10)
    g2 = build_graph(pkg, seed=11)
    assert g1.n_vertices == g2.n_vertices
    assert g1.trace_digest() != g2.trace_digest()
    pkg.core.latency_sweep(g1, [50.0, 100.0, 200.0], m=2)
    (entry,) = list(cache_env.glob("*.npz"))
    fake = cache_env / (g2.trace_digest()[:32] +
                        entry.name[len(g1.trace_digest()[:32]):])
    shutil.copy(entry, fake)
    assert pkg.sc.load(g2.trace_digest(), 2, 0, g2.n_vertices, 1.0) is None


def test_partially_stale_plan_is_replaced(pkg, cache_env):
    sc = pkg.sc
    g = build_graph(pkg, seed=0, n=80)
    pkg.core.latency_sweep(g, [50.0, 100.0, 200.0], m=2, compute_slots=1)
    tie_alphas = [0.5, 1.0, 2.0, 3.0]
    sc.reset_stats()
    assert bits(pkg.core.latency_sweep(g, tie_alphas, m=2, compute_slots=1),
                want(0, tie_alphas, n=80, m=2, compute_slots=1))
    assert sc.stats["record_runs"] >= 1 and sc.stats["stores"] >= 1


def test_reversed_topo_not_linear_extension(pkg):
    g = pkg.core.EDag()
    a = g.add_vertex(is_mem=True)
    b = g.add_vertex(is_mem=True)
    g.add_edge(a, b)
    g._finalize()
    assert pkg.sched._plan_from_cache(
        g, 2, 0, np.array([1, 0], dtype=np.int64),
        np.array([0, 1], dtype=np.int64), np.zeros(0, dtype=np.int64),
        None) is None


# -------------------------------------------------- concurrent store/prune

def _store_n_entries(sc, g, count):
    topo, O_mem, O_alu, level = schedule_arrays(g)
    for m in range(1, count + 1):
        assert sc.store(g.trace_digest(), m, 0, g.n_vertices, 1.0, topo,
                        O_mem, O_alu, level)


def test_prune_tolerates_concurrently_vanished_entries(pkg, cache_env,
                                                       monkeypatch):
    import pathlib
    _store_n_entries(pkg.sc, build_graph(pkg, seed=21), 6)
    entries = sorted(cache_env.glob("*.npz"))
    assert len(entries) == 6
    victim = entries[0]
    orig_stat = pathlib.Path.stat

    def racy_stat(self, **kw):
        if self == victim and os.path.exists(str(self)):
            os.unlink(str(self))
        return orig_stat(self, **kw)

    monkeypatch.setattr(pathlib.Path, "stat", racy_stat)
    gone = pkg.sc.prune(cap=2)
    monkeypatch.undo()
    assert gone == 3
    assert len(list(cache_env.glob("*.npz"))) == 2


def test_prune_tolerates_unlink_race(pkg, cache_env, monkeypatch):
    import pathlib
    _store_n_entries(pkg.sc, build_graph(pkg, seed=22), 5)
    victim = sorted(cache_env.glob("*.npz"))[0]
    orig_unlink = pathlib.Path.unlink

    def racy_unlink(self, **kw):
        if self == victim and os.path.exists(str(self)):
            os.unlink(str(self))
        return orig_unlink(self, **kw)

    monkeypatch.setattr(pathlib.Path, "unlink", racy_unlink)
    pkg.sc.prune(cap=1)
    monkeypatch.undo()
    assert len(list(cache_env.glob("*.npz"))) == 1


def test_concurrent_store_prune_two_processes(pkg, cache_env, monkeypatch):
    """One process storing (and auto-pruning), another pruning hard: both
    finish without an exception and what survives is well formed.  The
    child runs the other package, so the two share one directory."""
    import time
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MAX", "4")
    other = "repro" if pkg.name == "repro_torch" else "repro_torch"
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, time\n"
         f"sys.path.insert(0, {SRC!r})\n"
         f"from {other}.core import schedule_cache as sc\n"
         "deadline = time.time() + 2.0\n"
         "prunes = 0\n"
         "while time.time() < deadline:\n"
         "    sc.prune(cap=1)\n"
         "    prunes += 1\n"
         "print('PRUNES', prunes)\n"],
        env=dict(os.environ), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    g = build_graph(pkg, seed=23)
    deadline = time.time() + 1.5
    stored = 0
    while time.time() < deadline:
        _store_n_entries(pkg.sc, g, 4)
        stored += 4
    out, err = child.communicate(timeout=60)
    assert child.returncode == 0, err
    assert "PRUNES" in out and stored > 0
    for p in cache_env.glob("*.npz"):
        try:
            with np.load(p) as z:
                assert int(z["format"]) == pkg.sc._FORMAT
        except OSError:
            pass


# ----------------------------------------------------- quarantine-on-load

def test_corrupt_entry_quarantined_then_warm(pkg, cache_env):
    sc, sweep = pkg.sc, pkg.core.latency_sweep
    alphas = [50.0, 100.0, 200.0]
    w = want(30, alphas, m=3)
    assert bits(sweep(build_graph(pkg, seed=30), alphas, m=3), w)
    (entry,) = list(cache_env.glob("*.npz"))
    entry.write_bytes(b"definitely not a zip archive")
    sc.reset_stats()
    assert bits(sweep(build_graph(pkg, seed=30), alphas, m=3), w)
    assert sc.stats["quarantined"] == 1 and sc.stats["record_runs"] == 1
    assert (cache_env / (entry.name + ".bad")).exists()
    assert len(list(cache_env.glob("*.npz"))) == 1
    assert entry.exists()
    sc.reset_stats()
    assert bits(sweep(build_graph(pkg, seed=30), alphas, m=3), w)
    assert sc.stats["disk_hits"] == 1 and sc.stats["record_runs"] == 0


def test_old_format_entry_quarantined(pkg, cache_env):
    sc = pkg.sc
    g = build_graph(pkg, seed=31)
    path = _plant_format2(sc, cache_env, g)
    sc.reset_stats()
    assert sc.load(g.trace_digest(), 4, 0, g.n_vertices, 1.0) is None
    assert sc.stats["quarantined"] == 1
    assert not path.exists()
    assert path.with_name(path.name + ".bad").exists()


def test_plain_miss_quarantines_nothing(pkg, cache_env):
    pkg.sc.reset_stats()
    assert pkg.sc.load("f" * 64, 4, 0, 10, 1.0) is None
    assert pkg.sc.stats["quarantined"] == 0
    assert list(cache_env.glob("*.bad")) == []


def test_quarantine_warns_once(pkg, cache_env, caplog, monkeypatch):
    import logging
    sc = pkg.sc
    monkeypatch.setattr(sc, "_warned_quarantine", False)
    g1, g2 = build_graph(pkg, seed=32), build_graph(pkg, seed=33)
    for g in (g1, g2):
        pkg.core.latency_sweep(g, [50.0, 100.0], m=2)
    for p in cache_env.glob("*.npz"):
        p.write_bytes(b"garbage")
    with caplog.at_level(logging.WARNING, logger=sc.__name__):
        assert sc.load(g1.trace_digest(), 2, 0, g1.n_vertices, 1.0) is None
        assert sc.load(g2.trace_digest(), 2, 0, g2.n_vertices, 1.0) is None
    warned = [r for r in caplog.records if "quarantined" in r.message]
    assert len(warned) == 1
    assert sc.stats["quarantined"] >= 2


def test_bad_files_counted_against_prune_cap(pkg, cache_env):
    sc = pkg.sc
    g = build_graph(pkg, seed=34)
    _store_n_entries(sc, g, 4)
    for p in list(cache_env.glob("*.npz"))[:3]:
        p.write_bytes(b"garbage")
        assert sc.load("x" * 64, 99, 0, 1, 1.0) is None
    for m in range(1, 5):
        sc.load(g.trace_digest(), m, 0, g.n_vertices, 1.0)
    assert len(list(cache_env.glob("*.npz.bad"))) == 3
    assert sc.prune(cap=2) >= 1
    assert len(list(cache_env.glob("*.npz")) +
               list(cache_env.glob("*.npz.bad"))) <= 2


def test_crash_mid_store_leaves_nothing_or_valid(pkg, cache_env):
    import signal
    child = subprocess.Popen(
        [sys.executable, "-c",
         "import os, sys, time\n"
         f"sys.path.insert(0, {SRC!r})\n"
         "import numpy as np\n"
         f"from {pkg.name}.core import schedule_cache as sc\n"
         "real_replace = os.replace\n"
         "def slow_replace(a, b):\n"
         "    print('REPLACING', flush=True)\n"
         "    time.sleep(30)\n"
         "    real_replace(a, b)\n"
         "os.replace = slow_replace\n"
         "n = 50\n"
         "sc.store('a' * 64, 4, 0, n, 1.0, np.arange(n), np.arange(n),\n"
         "         np.zeros(0, dtype=np.int64), np.zeros(n, np.int64))\n"],
        env=dict(os.environ), stdout=subprocess.PIPE, text=True)
    assert child.stdout.readline().strip() == "REPLACING"
    os.kill(child.pid, signal.SIGKILL)
    child.wait(timeout=30)
    assert list(cache_env.glob("*.npz")) == []
    assert pkg.sc.load("a" * 64, 4, 0, 50, 1.0) is None
    n = 50
    assert pkg.sc.store("a" * 64, 4, 0, n, 1.0, np.arange(n), np.arange(n),
                        np.zeros(0, dtype=np.int64), np.zeros(n, np.int64))
    assert pkg.sc.load("a" * 64, 4, 0, n, 1.0) is not None


# ------------------------------------------- memory-mapped entries (format 4)

def _mmap_backed(a) -> bool:
    while a is not None:
        if isinstance(a, np.memmap):
            return True
        a = getattr(a, "base", None)
    return False


def test_mmap_dir_roundtrip_and_backing(pkg, mmap_env):
    sc = pkg.sc
    g = build_graph(pkg, seed=40)
    n = g.n_vertices
    rng = np.random.default_rng(1)
    topo = rng.permutation(n).astype(np.int64)
    O_mem = rng.permutation(np.flatnonzero(g.is_mem)).astype(np.int64)
    O_alu = np.zeros(0, dtype=np.int64)
    level = rng.integers(0, n, size=n).astype(np.int64)
    assert sc.store(g.trace_digest(), 4, 0, n, 1.0, topo, O_mem, O_alu,
                    level)
    assert list(mmap_env.glob("*.npz")) == []
    (entry,) = list(mmap_env.glob("*.d"))
    assert entry.is_dir() and (entry / "meta.npz").exists()
    got = sc.load(g.trace_digest(), 4, 0, n, 1.0)
    assert got is not None
    for w, have in zip((topo, O_mem, O_alu, level), got):
        assert np.array_equal(w, have)
        if len(have):
            assert _mmap_backed(have) and not have.flags.writeable
    assert sc.load(g.trace_digest(), 3, 0, n, 1.0) is None
    assert sc.load(g.trace_digest(), 4, 0, n + 1, 1.0) is None


def test_mmap_warm_sweep_bitexact(pkg, mmap_env):
    """A warm sweep replays from read-only memory maps: the device copies
    are made from them without a warning, and nothing writes through
    them."""
    sc, sweep = pkg.sc, pkg.core.latency_sweep
    alphas = [50.0, 100.0, 200.0]
    w = want(41, alphas, m=3)
    assert bits(sweep(build_graph(pkg, seed=41), alphas, m=3), w)
    assert sc.stats["record_runs"] == 1 and sc.stats["stores"] == 1
    assert list(mmap_env.glob("*.d")) != []
    sc.reset_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        warm = sweep(build_graph(pkg, seed=41), alphas, m=3)
    assert sc.stats["disk_hits"] == 1 and sc.stats["record_runs"] == 0
    assert sc.stats["record_seconds"] == 0.0
    assert bits(warm, w)


def test_mmap_corrupt_dir_quarantined_then_warm(pkg, mmap_env):
    sc, sweep = pkg.sc, pkg.core.latency_sweep
    alphas = [50.0, 100.0, 200.0]
    w = want(42, alphas, m=2)
    assert bits(sweep(build_graph(pkg, seed=42), alphas, m=2), w)
    (entry,) = list(mmap_env.glob("*.d"))
    (entry / "meta.npz").write_bytes(b"definitely not a zip archive")
    sc.reset_stats()
    assert bits(sweep(build_graph(pkg, seed=42), alphas, m=2), w)
    assert sc.stats["quarantined"] == 1 and sc.stats["record_runs"] == 1
    assert (entry.parent / (entry.name + ".bad")).is_dir()
    assert entry.is_dir()
    sc.reset_stats()
    assert bits(sweep(build_graph(pkg, seed=42), alphas, m=2), w)
    assert sc.stats["disk_hits"] == 1 and sc.stats["record_runs"] == 0


def test_mmap_truncated_array_rejected(pkg, mmap_env):
    g = build_graph(pkg, seed=43)
    n = g.n_vertices
    topo, O_mem, O_alu, level = schedule_arrays(g)
    assert pkg.sc.store(g.trace_digest(), 4, 0, n, 1.0, topo, O_mem, O_alu,
                        level)
    (entry,) = list(mmap_env.glob("*.d"))
    np.save(entry / "topo.npy", topo[: n // 2].astype(np.int32))
    assert pkg.sc.load(g.trace_digest(), 4, 0, n, 1.0) is None


def test_mmap_prune_removes_directories(pkg, mmap_env):
    _store_n_entries(pkg.sc, build_graph(pkg, seed=44), 5)
    assert len(list(mmap_env.glob("*.d"))) == 5
    assert pkg.sc.prune(cap=2) == 3
    assert len(list(mmap_env.glob("*.d"))) == 2
    assert pkg.sc.clear() == 2
    assert list(mmap_env.glob("*.d")) == []


def test_mmap_threshold_selects_format(pkg, cache_env, monkeypatch):
    sc = pkg.sc
    g = build_graph(pkg, seed=45)
    n = g.n_vertices
    arrays = schedule_arrays(g)
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MMAP_MIN", str(n + 1))
    assert sc.store(g.trace_digest(), 4, 0, n, 1.0, *arrays)
    assert list(cache_env.glob("*.d")) == []
    assert len(list(cache_env.glob("*.npz"))) == 1
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MMAP_MIN", str(n))
    assert sc.store(g.trace_digest(), 5, 0, n, 1.0, *arrays)
    assert len(list(cache_env.glob("*.d"))) == 1
    a = sc.load(g.trace_digest(), 4, 0, n, 1.0)
    b = sc.load(g.trace_digest(), 5, 0, n, 1.0)
    assert a is not None and b is not None
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


# ------------------------------------------- across the packages, both ways

GEMM_GRID = dict(alphas=[50.0, 100.0, 200.0], ms=(2, 4), compute_slots=(0, 3))


def _npz_members(path) -> dict:
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


@pytest.mark.parametrize("mmap_min", ["0", str(1 << 19)],
                         ids=["format4", "format3"])
@pytest.mark.parametrize("writer", sorted(PKGS))
def test_cache_entries_load_across_packages(writer, mmap_min, cache_env,
                                            monkeypatch, tmp_path):
    """Entries one package writes are disk hits for the other, with equal
    grids, and both packages write the same bytes: every member of a
    format-3 archive, every file of a format-4 directory."""
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MMAP_MIN", mmap_min)
    W = PKGS[writer]
    Rd = PKGS["repro_torch" if writer == "repro" else "repro"]
    cold = W.core.sweep_grid(W.poly.trace_kernel("gemm", 8), **GEMM_GRID)
    assert W.sc.stats["stores"] == 4
    Rd.sc.reset_stats()
    warm = Rd.core.sweep_grid(Rd.poly.trace_kernel("gemm", 8), **GEMM_GRID)
    assert Rd.sc.stats["disk_hits"] == 4 and Rd.sc.stats["record_runs"] == 0
    assert Rd.sc.stats["quarantined"] == 0
    assert bits(cold, warm)
    # the reading package's own cold recording writes the same bytes
    other = tmp_path / "other"
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", str(other))
    Rd.core.sweep_grid(Rd.poly.trace_kernel("gemm", 8), **GEMM_GRID)
    names = sorted(p.name for p in cache_env.iterdir()
                   if p.name != "other")
    assert names == sorted(p.name for p in other.iterdir()) and \
        len(names) == 4
    for name in names:
        a, b = cache_env / name, other / name
        if a.is_dir():
            for f in sorted(os.listdir(a)):
                if f.endswith(".npz"):
                    assert _npz_members(a / f) == _npz_members(b / f)
                else:
                    assert (a / f).read_bytes() == (b / f).read_bytes(), f
        else:
            assert _npz_members(a) == _npz_members(b)


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_trace_store_loads_across_packages(writer, tmp_path):
    """A trace one package stores, the other opens (mmap, digest-verified)
    and sweeps to the same makespans; the two stores are byte-identical."""
    W = PKGS[writer]
    Rd = PKGS["repro_torch" if writer == "repro" else "repro"]
    p = W.core.save_edag(W.poly.trace_kernel("atax", 6), tmp_path / "w")
    g = Rd.core.load_edag(p)
    assert _mmap_backed(np.asarray(g.src))
    alphas = [50.0, 100.0]
    assert bits(Rd.core.sweep_grid(g, alphas, ms=(2, 4), use_cache=False),
                W.core.sweep_grid(W.core.load_edag(p), alphas, ms=(2, 4),
                                  use_cache=False))
    q = Rd.core.save_edag(Rd.poly.trace_kernel("atax", 6), tmp_path / "r")
    assert sorted(os.listdir(p)) == sorted(os.listdir(q))
    for f in os.listdir(p):
        assert (p / f).read_bytes() == (q / f).read_bytes(), f


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_suite_and_trace_store_warm_each_other_across_packages(
        writer, cache_env, monkeypatch, tmp_path):
    """The suite's per-member disk tier shares entries across packages:
    one package's suite warms the other's suite over stored traces."""
    monkeypatch.setenv("EDAN_TRACE_STORE", str(tmp_path / "traces"))
    W = PKGS[writer]
    Rd = PKGS["repro_torch" if writer == "repro" else "repro"]
    names = ("atax", "bicg")
    gs = [W.poly.trace_kernel(nm, 6) for nm in names]
    digests = [str(W.core.put_trace(g).name) for g in gs]
    cold = W.core.suite_sweep_grid(W.core.EDagSuite(gs), [60.0, 120.0],
                                   ms=(2, 4), compute_slots=(0,))
    Rd.sc.reset_stats()
    got = [Rd.core.get_trace(d) for d in digests]
    warm = Rd.core.suite_sweep_grid(Rd.core.EDagSuite(got), [60.0, 120.0],
                                    ms=(2, 4), compute_slots=(0,))
    assert Rd.sc.stats["record_runs"] == 0
    assert Rd.sc.stats["disk_hits"] == len(names) * 2
    assert bits(cold, warm)


def test_recorded_schedules_equal_across_packages(cache_env):
    """The port records the reference's schedule (topological order, issue
    orders, augmented levels) on the same trace and machine."""
    g = rpoly.trace_kernel("mvt", 6)
    t = tpoly.trace_kernel("mvt", 6)
    for m, cs in ((2, 0), (3, 2)):
        _, rp = rsched._record_plan(g, g._sim_lists(), m, cs, 50.0, 1.0,
                                    persist=False)
        _, tp = tsched._record_plan(t, t._sim_lists(), m, cs, 50.0, 1.0,
                                    persist=False)
        for name in ("topo", "O_mem", "O_alu", "level_aug"):
            assert np.array_equal(getattr(rp, name), getattr(tp, name)), name
        assert rp.array_nbytes() == tp.array_nbytes()
    g._finalize()
    t._finalize()
    assert g.array_nbytes() == t.array_nbytes()


# --------------------------------------------------- streaming vs legacy

_ALPHAS = [3.0, 50.0, 200.0]


def _random_stream(g, seed: int, n_ops: int, p_block: float,
                   p_unsorted: float) -> None:
    """A deterministic random vertex/edge stream appended to ``g``."""
    rng = np.random.default_rng(seed)
    while g.n_vertices < 3:
        g.add_vertex(is_mem=bool(rng.random() < 0.5), nbytes=8.0)
    for _ in range(n_ops):
        r = rng.random()
        n = g.n_vertices
        if r < p_block:
            k = int(rng.integers(2, 12))
            if rng.random() < 0.5:
                g.add_vertex_block(rng.random(k), rng.random(k) < 0.4,
                                   8.0 * rng.random(k),
                                   label=[f"l{i % 3}" for i in range(k)])
            else:
                g.add_vertex_block(1.0, bool(rng.random() < 0.5), 8.0,
                                   label="blk", n=k)
            base = n
            n = g.n_vertices
            dst = rng.integers(base, n, size=min(2 * k, n - 1))
            src = (rng.random(len(dst)) * dst).astype(np.int64)
            if rng.random() < p_unsorted:
                dst = dst[::-1].copy()
                src = src[::-1].copy()
                order = np.argsort(src, kind="stable")
                src, dst = src[order], dst[order]
            g.add_edge_block(src, dst)
        else:
            v = g.add_vertex(cost=float(rng.random()),
                             is_mem=bool(rng.random() < 0.5),
                             nbytes=float(rng.integers(0, 64)),
                             label=f"v{int(rng.integers(0, 4))}")
            for _ in range(int(rng.integers(0, 3))):
                g.add_edge(int(rng.integers(0, v)), v)


def _assert_bit_identical(gs, gl) -> None:
    gs._finalize()
    gl._finalize()
    assert gs.trace_digest() == gl.trace_digest()
    for name in ("src", "dst", "level", "cost", "is_mem", "nbytes"):
        assert bits(getattr(gs, name), getattr(gl, name)), name
    assert list(gs.labels()) == list(gl.labels())


def _both_builds(stream, **kw) -> None:
    """The stream through the reference's streaming build and the port's
    streaming and legacy builds: all bit-identical, equal makespans."""
    ref = R.EDag()
    ts, tl = T.EDag(), T.EDag(legacy_build=True)
    assert not ts._legacy and tl._legacy
    for g in (ref, ts, tl):
        stream(g, **kw)
    _assert_bit_identical(ts, tl)
    _assert_bit_identical(ts, ref)
    want_ = R.latency_sweep(ref, _ALPHAS, use_cache=False)
    assert bits(T.latency_sweep(ts, _ALPHAS, use_cache=False), want_)
    assert bits(T.latency_sweep(tl, _ALPHAS, use_cache=False), want_)


@given(st.integers(0, 2 ** 31), st.integers(4, 40), st.floats(0.1, 0.9))
def test_streaming_equals_legacy(seed, n_ops, p_block):
    _both_builds(_random_stream, seed=seed, n_ops=n_ops, p_block=p_block,
                 p_unsorted=0.0)


@given(st.integers(0, 2 ** 31), st.integers(4, 30))
def test_unsorted_chunks_equal_legacy(seed, n_ops):
    _both_builds(_random_stream, seed=seed, n_ops=n_ops, p_block=0.8,
                 p_unsorted=0.9)


@given(st.integers(0, 2 ** 31), st.integers(3, 20), st.integers(3, 20))
def test_incremental_refinalize_equals_oneshot(seed, ops_a, ops_b):
    gs = T.EDag()
    gl = T.EDag(legacy_build=True)
    ref = R.EDag(legacy_build=True)
    for g in (gs, gl, ref):
        _random_stream(g, seed, ops_a, p_block=0.5, p_unsorted=0.2)
    gs._finalize()
    for g in (gs, gl, ref):
        _random_stream(g, seed + 1, ops_b, p_block=0.5, p_unsorted=0.2)
    _assert_bit_identical(gs, gl)
    _assert_bit_identical(gs, ref)


def test_pending_buffer_flush_boundary(monkeypatch):
    monkeypatch.setattr(tgraph, "_CHUNK_FLUSH", 7)

    def stream(g):
        for i in range(40):
            g.add_vertex(is_mem=(i % 3 == 0), nbytes=float(i))
            if i:
                g.add_edge(i - 1, i)
        g.add_edge_block([0, 1], [5, 7])

    _both_builds(stream)


def test_legacy_env_knob(pkg, monkeypatch):
    E = pkg.core.EDag
    monkeypatch.setenv("EDAN_LEGACY_BUILD", "1")
    assert E()._legacy
    monkeypatch.setenv("EDAN_LEGACY_BUILD", "0")
    assert not E()._legacy
    monkeypatch.delenv("EDAN_LEGACY_BUILD")
    assert not E()._legacy
    assert E(legacy_build=True)._legacy


def test_traced_app_identical_under_both_builds(monkeypatch):
    g = tpoly.trace_kernel("gemm", 6)
    monkeypatch.setenv("EDAN_LEGACY_BUILD", "1")
    gl = tpoly.trace_kernel("gemm", 6)
    ref = rpoly.trace_kernel("gemm", 6)
    assert gl._legacy and not g._legacy and ref._legacy
    _assert_bit_identical(g, gl)
    _assert_bit_identical(g, ref)


# ------------------------------------------------------------- trace store

def _traced(P, seed: int = 0, n: int = 50):
    g = P.core.EDag()
    rng = np.random.default_rng(seed)
    for i in range(n):
        g.add_vertex(cost=float(rng.random()),
                     is_mem=bool(rng.random() < 0.5), nbytes=8.0,
                     label=f"v{i % 4}")
        for j in range(max(0, i - 4), i):
            if rng.random() < 0.4:
                g.add_edge(j, i)
    g._finalize()
    return g


def _ref_sweep(seed: int):
    return R.latency_sweep(_traced(PKGS["repro"], seed), _ALPHAS,
                           use_cache=False)


def test_store_roundtrip_mmap(pkg, tmp_path):
    g = _traced(pkg)
    p = pkg.core.save_edag(g, tmp_path / "t")
    assert (p / "meta.json").exists()
    g2 = pkg.core.load_edag(p)
    assert g2.trace_digest() == g.trace_digest()
    for name in ("src", "level", "cost"):
        assert np.array_equal(getattr(g2, name), getattr(g, name))
    assert _mmap_backed(np.asarray(g2.src))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = pkg.core.latency_sweep(g2, _ALPHAS, use_cache=False)
    assert bits(got, _ref_sweep(0))
    with pytest.raises(ValueError):
        g2.add_vertex()
    with pytest.raises(ValueError):
        g2.add_edge(0, 1)


def test_store_roundtrip_eager(pkg, tmp_path):
    g = _traced(pkg, seed=1)
    g2 = pkg.core.load_edag(pkg.core.save_edag(g, tmp_path / "t"),
                            mmap=False)
    assert not _mmap_backed(np.asarray(g2.src))
    assert g2.trace_digest() == g.trace_digest()
    assert np.array_equal(g2.dst, g.dst)


def test_store_missing_derived_recomputed(pkg, tmp_path):
    g = _traced(pkg, seed=2)
    p = pkg.core.save_edag(g, tmp_path / "t", include_derived=False)
    for name in pkg.store._DERIVED:
        assert not (p / f"{name}.npy").exists()
    g2 = pkg.core.load_edag(p)
    assert np.array_equal(g2.level, g.level)
    assert bits(pkg.core.latency_sweep(g2, _ALPHAS, use_cache=False),
                _ref_sweep(2))


def test_store_digest_verification_catches_corruption(pkg, tmp_path):
    g = _traced(pkg, seed=3)
    p = pkg.core.save_edag(g, tmp_path / "t")
    meta = json.loads((p / "meta.json").read_text())
    meta["digest"] = "0" * len(meta["digest"])
    (p / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="digest"):
        pkg.core.load_edag(p)
    g3 = pkg.core.load_edag(p, verify=False)
    assert np.array_equal(g3.src, g.src)


def test_put_get_trace_digest_addressed(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("EDAN_TRACE_STORE", str(tmp_path))
    g = _traced(pkg, seed=4)
    p = pkg.core.put_trace(g)
    assert p is not None and str(p).startswith(str(tmp_path))
    g2 = pkg.core.get_trace(g.trace_digest())
    assert g2 is not None and g2.trace_digest() == g.trace_digest()
    assert pkg.core.get_trace("f" * 64) is None
    monkeypatch.setenv("EDAN_TRACE_STORE", "off")
    assert pkg.core.put_trace(g) is None
    assert pkg.core.get_trace(g.trace_digest()) is None


def test_store_save_requires_no_prior_finalize(pkg, tmp_path):
    g = pkg.core.EDag()
    a = g.add_vertex(is_mem=True)
    b = g.add_vertex()
    g.add_edge(a, b)
    g2 = pkg.core.load_edag(pkg.core.save_edag(g, tmp_path / "t"))
    assert g2.n_vertices == 2 and g2.n_edges == 1


# ------------------------------------------------ environment hardening

BAD_NUMERIC = ["", "  ", "abc", "-5"]


def _chain(P, n: int = 12):
    g = P.core.EDag()
    prev = None
    for i in range(n):
        v = g.add_vertex(is_mem=(i % 2 == 0))
        if prev is not None:
            g.add_edge(prev, v)
        prev = v
    return g


@pytest.mark.parametrize("val", BAD_NUMERIC)
def test_replay_mem_budget_env_falls_back(pkg, monkeypatch, val):
    monkeypatch.setenv("EDAN_REPLAY_MEM_BUDGET", val)
    assert pkg.plan.replay_mem_budget() == pkg.plan.REPLAY_MEM_BUDGET
    alphas = [50.0, 100.0, 200.0]
    ref = _chain(PKGS["repro"])
    assert bits(pkg.core.latency_sweep(_chain(pkg), alphas, m=2),
                np.array([R.simulate_reference(ref, m=2, alpha=a)
                          for a in alphas]))


@pytest.mark.parametrize("val", BAD_NUMERIC)
def test_schedule_cache_min_env_falls_back(pkg, monkeypatch, val):
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MIN", val)
    assert pkg.sc.min_vertices() == pkg.sc._DEFAULT_MIN_VERTICES


def test_schedule_cache_min_zero_is_valid(pkg, monkeypatch):
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MIN", "0")
    assert pkg.sc.min_vertices() == 0


@pytest.mark.parametrize("val", BAD_NUMERIC)
def test_schedule_cache_max_env_falls_back(pkg, monkeypatch, val):
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MAX", val)
    assert pkg.sc.max_entries() == pkg.sc._DEFAULT_MAX_ENTRIES


def test_schedule_cache_max_valid_env(pkg, monkeypatch):
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MAX", "7")
    assert pkg.sc.max_entries() == 7
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MAX", "0")
    assert pkg.sc.max_entries() == 1


@pytest.mark.parametrize("val", BAD_NUMERIC)
def test_schedule_cache_mmap_min_env_falls_back(pkg, monkeypatch, val):
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MMAP_MIN", val)
    assert pkg.sc.mmap_min_vertices() == pkg.sc._DEFAULT_MMAP_MIN


def test_bad_numeric_envs_do_not_break_cached_sweeps(pkg, monkeypatch,
                                                     tmp_path):
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", str(tmp_path))
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MIN", "  ")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MAX", "abc")
    monkeypatch.setenv("EDAN_REPLAY_MEM_BUDGET", "-1")
    alphas = [50.0, 150.0, 250.0]
    ref = _chain(PKGS["repro"], 20)
    assert bits(pkg.core.latency_sweep(_chain(pkg, 20), alphas, m=3,
                                       compute_slots=2),
                np.array([R.simulate_reference(ref, m=3, alpha=a,
                                               compute_slots=2)
                          for a in alphas]))


@pytest.mark.parametrize("val", ["off", "0", "none", "disabled", " OFF "])
def test_cache_and_store_off_values(pkg, monkeypatch, val):
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", val)
    monkeypatch.setenv("EDAN_TRACE_STORE", val)
    assert pkg.sc.cache_dir() is None
    assert pkg.core.trace_store_dir() is None


def test_cache_dir_default_location(pkg, monkeypatch, tmp_path):
    """Both packages resolve the same default directory, so they share
    it."""
    monkeypatch.delenv("EDAN_SCHEDULE_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert pkg.sc.cache_dir() == tmp_path / "edan" / "schedules"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert pkg.sc.cache_dir() == tmp_path / ".cache" / "edan" / "schedules"
