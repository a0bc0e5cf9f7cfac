"""The port's level kernel dispatch (``repro_torch.core.backend``) against the
JAX package's (``repro.core.backend``).

On the CPU the level kernel's wrapper takes its plain PyTorch version, so
these tests hold that version bitwise to the reference numpy kernel
(``_accumulate_numpy``) and, in float32, to the Pallas kernel itself run in
interpret mode.  Max is exact and each finish is one IEEE add, so every
comparison is exact equality.  Data is made with numpy from a seed and
handed to both packages.
"""
import numpy as np
import pytest
import torch

import repro.core.backend as rbk
from repro.core import EDag as REDag
from repro.core import concat_edags
from repro.core import scheduler as rsched
import repro_torch.core.backend as tbk
from repro_torch.kernels.level_step import level_step, level_step_plain

jax = pytest.importorskip("jax")

DIRTY_ALPHAS = (0.1, 1.0 / 3.0, 333.333, float(np.float32(1.0 / 3.0)) * 256)
CLEAN_ALPHAS = (50.0, 75.0, 125.0, 200.0, 300.0)


@pytest.fixture(autouse=True)
def cpu_backend(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")
    for knob in ("EDAN_X64", "EDAN_REPLAY_DTYPE", "EDAN_BACKEND"):
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture
def x64_off():
    was = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", was)


def _random_edag(seed: int, n: int = 40, p: float = 0.15) -> REDag:
    rng = np.random.default_rng(seed)
    g = REDag()
    for i in range(n):
        g.add_vertex(cost=float(rng.integers(1, 5)),
                     is_mem=bool(rng.random() < 0.5))
        for j in range(i):
            if rng.random() < p:
                g.add_edge(j, i)
    g._finalize()
    return g


def port_csr(lv) -> tbk.LevelCSR:
    """The port's LevelCSR over the reference partition's numpy fields."""
    return tbk.LevelCSR(n=lv.n, n_levels=lv.n_levels, esrc=lv.esrc,
                        run_dst=lv.run_dst, run_starts=lv.run_starts,
                        run_lens=lv.run_lens, run_ptr=lv.run_ptr,
                        elevel_ptr=lv.elevel_ptr, qpred=lv.qpred,
                        qonly_ptr=lv.qonly_ptr, qonly_dst=lv.qonly_dst,
                        seg_ptr=lv.seg_ptr)


def _replay_lv(g: REDag, m: int, cs: int, alpha: float = 40.0):
    """A reference replay plan's order-augmented partition (slot chains,
    queue-only vertices)."""
    _, plan = rsched._record_plan(g, g._sim_lists(), m, cs, alpha, 1.0,
                                  persist=False)
    return plan.lv


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def _case_lv(seed: int, slot: bool):
    g = _random_edag(seed)
    return _replay_lv(g, 2, 3) if slot else g._level_csr()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("want_r", [False, True])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("slot", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_kernel_bitwise_vs_numpy(seed, slot, clamp, want_r, dtype):
    lv = _case_lv(seed, slot)
    rng = np.random.default_rng(seed + 100)
    rows = lv.n + (1 if slot else 0)
    base = rng.standard_normal((rows, 4)).astype(dtype)
    if slot:
        base[-1] = 0
    F0, R0 = base.copy(), np.zeros_like(base)
    rbk._accumulate_numpy(lv, F0, clamp=clamp,
                          R_out=R0 if want_r else None)
    F1 = torch.from_numpy(base.copy())
    R1 = torch.zeros_like(F1) if want_r else None
    out = level_step(port_csr(lv), F1, clamp=clamp, R_out=R1)
    assert out is F1
    assert np.array_equal(_bits(F0), _bits(F1.numpy()))
    if want_r:
        assert np.array_equal(_bits(R0), _bits(R1.numpy()))


def test_plain_kernel_one_column_vector_and_nan():
    g = _random_edag(5)
    lv = g._level_csr()
    base = np.random.default_rng(5).standard_normal(g.n_vertices)
    base[3] = np.nan
    want = rbk._accumulate_numpy(lv, base.copy()[:, None])[:, 0]
    got = level_step_plain(port_csr(lv), torch.from_numpy(base.copy()))
    assert np.array_equal(want, got.numpy(), equal_nan=True)


@pytest.mark.parametrize("seed,slot", [(0, False), (1, True), (2, True)])
def test_plain_kernel_vs_pallas_interpret_f32(seed, slot, x64_off):
    """The port's kernel semantics against K1 itself, run as the JAX
    package runs it on the CPU (interpret mode, float32)."""
    lv = _case_lv(seed, slot)
    rng = np.random.default_rng(seed + 7)
    rows = lv.n + (1 if slot else 0)
    base = rng.integers(1, 50, size=(rows, 3)).astype(np.float32)
    if slot:
        base[-1] = 0
    F0, R0 = base.copy(), np.zeros_like(base)
    rbk._accumulate_jax(lv, F0, clamp=not slot, R_out=R0)
    F1 = torch.from_numpy(base.copy())
    R1 = torch.zeros_like(F1)
    level_step(port_csr(lv), F1, clamp=not slot, R_out=R1)
    assert np.array_equal(F0, F1.numpy())
    assert np.array_equal(R0, R1.numpy())


def test_union_blocks_and_segment_reductions():
    """A block-diagonal union (seg_ptr blocks): the plain kernel over the
    union equals the reference, and the segmented reductions equal the
    reference's row for row."""
    members = [_random_edag(s, n=25) for s in range(3)]
    u = concat_edags(members)
    u._finalize()
    lv = u._level_csr()
    seg = np.concatenate(([0], np.cumsum([g.n_vertices for g in members])))
    lv.seg_ptr = seg
    base = np.random.default_rng(9).standard_normal((u.n_vertices, 3))
    F0 = rbk._accumulate_numpy(lv, base.copy())
    F1 = torch.from_numpy(base.copy())
    level_step(port_csr(lv), F1)
    assert np.array_equal(F0, F1.numpy())
    for i, g in enumerate(members):
        Fi = rbk._accumulate_numpy(g._level_csr(),
                                   base[seg[i]:seg[i + 1]].copy())
        assert np.array_equal(Fi, F1.numpy()[seg[i]:seg[i + 1]])
    seg_e = np.array([0, 10, 10, seg[-1]])
    for s in (seg, seg_e):
        assert np.array_equal(rbk.segment_max_rows(F0, s),
                              tbk.segment_max_rows(F1, s).numpy())
        assert np.array_equal(rbk.segment_sum_rows(F0, s),
                              tbk.segment_sum_rows(F1, s).numpy())


def test_partition_and_levelize_match():
    g = _random_edag(4)
    lv = g._level_csr()
    got = tbk.build_level_partition(g.src, g.dst, g.level, g.n_vertices)
    for name in ("esrc", "run_dst", "run_starts", "run_lens", "run_ptr",
                 "elevel_ptr"):
        assert np.array_equal(getattr(lv, name), getattr(got, name)), name
    assert got.level_maxlens() == lv.level_maxlens()
    assert np.array_equal(rbk.levelize(g.src, g.dst, g.n_vertices),
                          tbk.levelize(g.src, g.dst, g.n_vertices))


# ------------------------------------------------------------ selection

def test_select_backend_choices_and_typos(monkeypatch):
    assert tbk.select_backend("cpu") == "cpu"
    assert tbk.select_backend() == "cpu"
    with pytest.raises(ValueError, match="backend value 'jax'"):
        tbk.select_backend("jax")
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "gpu")
    with pytest.raises(ValueError, match="EDAN_TORCH_BACKEND"):
        tbk.select_backend()


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbk.select_backend("cuda")
    monkeypatch.delenv("EDAN_TORCH_BACKEND")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbk.select_backend()
    g = _random_edag(0)
    lv = port_csr(g._level_csr())
    F = torch.zeros((g.n_vertices, 2), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbk.replay_accumulate(lv, F, np.ones(2))


def test_matrix_on_the_wrong_device_raises():
    g = _random_edag(0)
    lv = port_csr(g._level_csr())
    F = torch.zeros((g.n_vertices, 2), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="lies on meta"):
        tbk.level_accumulate(lv, F)


def test_replay_dtype_policy_matches_reference(monkeypatch):
    for env in ({}, {"EDAN_X64": "1"}, {"EDAN_X64": "off"},
                {"EDAN_REPLAY_DTYPE": "float64"},
                {"EDAN_X64": "0", "EDAN_REPLAY_DTYPE": "float64"}):
        for k in ("EDAN_X64", "EDAN_REPLAY_DTYPE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tbk.replay_dtype_policy() == rbk.replay_dtype_policy()
    for bad in ({"EDAN_X64": "maybe"}, {"EDAN_REPLAY_DTYPE": "double"}):
        for k in ("EDAN_X64", "EDAN_REPLAY_DTYPE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in bad.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(ValueError, match=list(bad)[0]):
            tbk.replay_dtype_policy()
    with pytest.raises(ValueError, match="replay_dtype"):
        tbk.replay_dtype_policy("half")


def test_column_quanta_and_thresholds_match():
    alphas = np.array([50.0, 0.1, 1.0 / 3.0, 2.0 ** -120, 300.0])
    assert np.array_equal(tbk.column_quanta(alphas, 1.0),
                          rbk.column_quanta(alphas, 1.0))
    rows = np.array([[50.0, 0.25], [3.0, 7.0]])
    assert np.array_equal(tbk.column_quanta(rows, 0.5),
                          rbk.column_quanta(rows, 0.5))
    q = rbk.column_quanta(alphas, 1.0)
    for L in (1, 100, 3_000_000):
        assert np.array_equal(tbk._f32_thresholds(q, L),
                              rbk._f32_thresholds(q, L))


def test_replay_accumulate_validates_inputs():
    g = _random_edag(0)
    lv = port_csr(g._level_csr())
    with pytest.raises(ValueError, match="float64"):
        tbk.replay_accumulate(lv, torch.zeros((10, 2)), np.ones(2))
    with pytest.raises(ValueError, match="quanta"):
        tbk.replay_accumulate(lv, torch.zeros((10, 2), dtype=torch.float64),
                              np.ones(3))


# ---------------------------------------------------------- certificate

def _cert_counts(stats) -> tuple:
    return stats["certified_columns"], stats["demoted_columns"]


def _drift_chain(n: int = 400) -> REDag:
    g = REDag()
    prev = None
    for _ in range(n):
        v = g.add_vertex(is_mem=True)
        if prev is not None:
            g.add_edge(prev, v)
        prev = v
    g._finalize()
    return g


@pytest.mark.parametrize("case", ["clean", "dirty", "drift"])
def test_certificate_decisions_match_reference_f32(case, x64_off):
    """The port's float32 certificate certifies and demotes exactly the
    columns the JAX package's float32 path does, and the makespans are
    the float64 ones bit for bit."""
    from repro.core import simulate_batch as r_sim, simulate_reference
    from repro_torch.core import EDag as TEDag, simulate_batch as t_sim
    if case == "clean":
        g, alphas, m, cs = _random_edag(3, n=60, p=0.1), CLEAN_ALPHAS, 3, 2
    elif case == "dirty":
        g, alphas, m, cs = (_random_edag(7, n=60, p=0.1),
                            DIRTY_ALPHAS + (50.0,), 2, 3)
    else:
        a = float(np.float32(1.0 / 3.0))
        g, alphas, m, cs = _drift_chain(), (a, 2 * a), 1, 0
    tg = TEDag.from_arrays(g.cost, g.is_mem, g.nbytes, g.src, g.dst)
    rbk.reset_stats()
    want = r_sim(g, alphas, m=m, compute_slots=cs, backend="jax",
                 replay_dtype="float32", use_cache=False)
    tbk.reset_stats()
    got = t_sim(tg, alphas, m=m, compute_slots=cs, backend="cpu",
                replay_dtype="float32", use_cache=False)
    ref = np.array([simulate_reference(g, m=m, alpha=a, compute_slots=cs)
                    for a in alphas])
    assert np.array_equal(got, want) and np.array_equal(got, ref)
    assert _cert_counts(tbk.stats) == _cert_counts(rbk.stats)
    assert tbk.stats["cpu_chunks"] == tbk.stats["chunks"] > 0
    assert tbk.stats["cuda_chunks"] == 0
    if case == "clean":
        assert tbk.stats["demoted_columns"] == 0
    else:
        assert tbk.stats["demoted_columns"] >= 2


def test_lossy_base_cast_is_screened_off():
    g = REDag()
    u = g.add_vertex(is_mem=False)
    v = g.add_vertex(is_mem=True)
    g.add_edge(u, v)
    g._finalize()
    lv = g._level_csr()
    alpha, unit = -(2.0 ** 24 + 1.0), 2.0 ** 23
    F = np.array([[unit], [alpha]], dtype=np.float64)
    want = rbk.replay_accumulate(lv, F.copy(), rbk.column_quanta([alpha], unit),
                                 clamp=True, backend="numpy")
    tbk.reset_stats()
    got = tbk.replay_accumulate(port_csr(lv), torch.from_numpy(F.copy()),
                                tbk.column_quanta([alpha], unit), clamp=True,
                                replay_dtype="float32")
    assert np.array_equal(want, got.numpy())
    assert _cert_counts(tbk.stats) == (0, 1)


def test_cpu_backend_without_explicit_dtype_runs_float64(monkeypatch):
    """On the cpu backend the environment's float32 knob is inert: the
    plain float64 version runs and nothing is certified."""
    monkeypatch.setenv("EDAN_REPLAY_DTYPE", "float32")
    g = _random_edag(2)
    lv = g._level_csr()
    base = np.random.default_rng(2).integers(1, 9, (g.n_vertices, 3)) * 1.0
    tbk.reset_stats()
    got = tbk.replay_accumulate(port_csr(lv), torch.from_numpy(base.copy()),
                                np.ones(3), clamp=True)
    assert np.array_equal(got.numpy(), rbk._accumulate_numpy(lv, base.copy()))
    assert dict(tbk.stats) == dict(chunks=1, cuda_chunks=0, cuda_f64_chunks=0,
                                   cpu_chunks=1, latency_bound_chunks=0,
                                   certified_columns=0, demoted_columns=0)


# ------------------------------------------------ latency-bound dispatch

def _dispatch_case(kind: str):
    """(plan, bases, quanta, columns the certificate accepts): a deep,
    narrow chain (400 levels, k = 2), a replay plan with slot chains
    (k = 3) and a wide, shallow plan at a large k (3 levels of 256, k =
    64).  The 0.1 columns fail the certificate; the rest pass it."""
    if kind == "chain":
        lv, alphas = port_csr(_drift_chain()._level_csr()), [1.0, 0.1]
        base = np.tile(alphas, (lv.n, 1))
        return lv, base, tbk.column_quanta(alphas, 1.0), 1
    if kind == "replay":
        lv = port_csr(_replay_lv(_random_edag(5, n=60, p=0.1), 2, 3))
        alphas = [50.0, 75.0, 0.1]
        base = np.tile(alphas, (lv.n + 1, 1))
        base[-1] = 0.0
        return lv, base, tbk.column_quanta(alphas, 1.0), 2
    lv = wide_plan(levels=3, width=256, deg=4)
    base = np.random.default_rng(3).integers(1, 300, (lv.n, 64)) * 1.0
    return lv, base, np.ones(64), 64


def wide_plan(levels: int, width: int, deg: int) -> tbk.LevelCSR:
    """``levels`` levels of ``width`` vertices; each vertex past the first
    level takes ``deg`` random predecessors on the level below."""
    rng = np.random.default_rng(0)
    n = levels * width
    dst = np.repeat(np.arange(width, n, dtype=np.int64), deg)
    src = (dst // width - 1) * width + rng.integers(0, width, len(dst))
    level = (np.arange(n) // width).astype(np.int32)
    return tbk.build_level_partition(src.astype(np.int32),
                                     dst.astype(np.int32), level, n)


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """The dispatch's card branch over host tensors: the cuda backend is
    selected while the passes run the plain version."""
    monkeypatch.setattr(tbk, "select_backend",
                        lambda override=None: "cuda")
    monkeypatch.setattr(tbk, "_check_device", lambda F, backend: None)


@pytest.mark.parametrize("named", [None, "x64_off", "argument",
                                   "environment"])
@pytest.mark.parametrize("kind", ["chain", "replay", "wide"])
def test_card_default_runs_the_float64_pass_alone(as_if_on_the_card,
                                                  monkeypatch, kind, named):
    """The card's float32 default (nothing names a dtype; a falsy
    ``$EDAN_X64`` names none) runs one float64 pass whatever the plan's
    shape, its columns counted as demoted; the float32 policy named by
    argument or environment runs the certificate whatever the shape.  The
    answers are the float64 pass's bit for bit."""
    lv, base, quanta, n_ok = _dispatch_case(kind)
    k = base.shape[1]
    R_want = torch.zeros(base.shape, dtype=torch.float64)
    want = tbk.replay_accumulate(lv, torch.from_numpy(base.copy()), quanta,
                                 R_out=R_want, replay_dtype="float64")
    if named == "x64_off":
        monkeypatch.setenv("EDAN_X64", "0")
    if named == "environment":
        monkeypatch.setenv("EDAN_REPLAY_DTYPE", "float32")
    tbk.reset_stats()
    R = torch.zeros(base.shape, dtype=torch.float64)
    got = tbk.replay_accumulate(
        lv, torch.from_numpy(base.copy()), quanta, R_out=R,
        replay_dtype="float32" if named == "argument" else None)
    assert torch.equal(got, want) and torch.equal(R, R_want)
    st = dict(tbk.stats)
    assert st["chunks"] == st["cpu_chunks"] == 1
    assert st["cuda_f64_chunks"] == 0
    if named in (None, "x64_off"):
        assert st["latency_bound_chunks"] == 1
        assert _cert_counts(st) == (0, k)
    else:
        assert st["latency_bound_chunks"] == 0
        assert _cert_counts(st) == (n_ok, k - n_ok)
