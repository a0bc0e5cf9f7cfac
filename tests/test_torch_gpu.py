"""Tests of the port that need the card: the CUDA kernels (level step,
WKV6, SSD, flash attention) against their plain versions (the level
kernel also on union and class-mode replay plans), the engine, the union
suite grids and the placement search on the card against the host, the
serving path on the card (the encoder-decoder's too), model-zoo tracing
(no kernel runs) and model requests on the card.

Marked ``gpu``; each test asks a fixture whether torch sees a CUDA device
and skips when it does not.  Run on a machine with the card:
``python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.apps import polybench
from repro_torch.core import backend as B
from repro_torch.core import scheduler as S
from repro_torch.core import sweep_report
from repro_torch.kernels.level_step import level_step, level_step_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cuda")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")
    for knob in ("EDAN_X64", "EDAN_REPLAY_DTYPE"):
        monkeypatch.delenv(knob, raising=False)
    return torch.device("cuda")


def _plan(name="gemm", N=10, m=4, cs=8):
    g = polybench.trace_kernel(name, N)
    g._finalize()
    _, plan = S._record_plan(g, g._sim_lists(), m, cs, 50.0, 1.0,
                             persist=False)
    return g, plan


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32
                               else torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("slot", [False, True])
def test_kernel_bitwise_vs_plain(card, dtype, slot):
    g, plan = _plan()
    lv = plan.lv if slot else g._level_csr()
    rows = lv.n + (1 if slot else 0)
    base = torch.from_numpy(np.random.default_rng(0).integers(
        1, 300, (rows, 6)) / 4.0).to(card, dtype)
    if slot:
        base[-1] = 0
    for clamp in (False, True):
        Fk, Fp = base.clone(), base.clone()
        Rk, Rp = torch.zeros_like(base), torch.zeros_like(base)
        n0 = level_step.launches
        level_step(lv, Fk, clamp=clamp, R_out=Rk)
        assert level_step.launches > n0
        level_step_plain(lv, Fp, clamp=clamp, R_out=Rp)
        torch.cuda.synchronize()
        assert torch.equal(_bits(Fk), _bits(Fp))
        assert torch.equal(_bits(Rk), _bits(Rp))


def test_kernel_propagates_nan_like_numpy(card):
    g = polybench.trace_kernel("atax", 6)
    lv = g._level_csr()
    base = np.random.default_rng(1).standard_normal(g.n_vertices)
    base[::7] = np.nan
    Fk = torch.from_numpy(base.copy()).to(card)
    Fp = torch.from_numpy(base.copy())
    level_step(lv, Fk)
    level_step_plain(lv, Fp)
    assert np.array_equal(Fk.cpu().numpy(), Fp.numpy(), equal_nan=True)


def test_wrapper_rejects_bad_inputs(card):
    g = polybench.trace_kernel("gemm", 4)
    lv = g._level_csr()
    with pytest.raises(ValueError, match="float32 or float64"):
        level_step(lv, torch.zeros((g.n_vertices, 2), dtype=torch.int32,
                                   device=card))
    with pytest.raises(ValueError, match="rows"):
        level_step(lv, torch.zeros((3, 2), device=card))
    with pytest.raises(ValueError, match="contiguous"):
        level_step(lv, torch.zeros((2, g.n_vertices), device=card).T)


def test_fault_hook_propagates(card, monkeypatch):
    def boom():
        raise RuntimeError("injected")
    monkeypatch.setattr(B, "fault_hook", boom)
    g = polybench.trace_kernel("gemm", 4)
    with pytest.raises(RuntimeError, match="injected"):
        g.finish_times()


@pytest.mark.parametrize("dtype", [None, "float64"])
def test_engine_on_card_equals_engine_on_host(card, dtype, monkeypatch):
    g = polybench.trace_kernel("lu", 10)
    B.reset_stats()
    on_card = sweep_report(g, [50.0, 125.0, 0.1, 300.0],
                           simulate_points=True, compute_slots=8,
                           replay_dtype=dtype)
    assert B.stats["cuda_chunks"] > 0 and B.stats["cpu_chunks"] == 0
    if dtype is None:
        assert B.stats["demoted_columns"] >= 1     # the 0.1 column
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    h = polybench.trace_kernel("lu", 10)
    on_host = sweep_report(h, [50.0, 125.0, 0.1, 300.0],
                           simulate_points=True, compute_slots=8)
    for k in on_host:
        assert np.array_equal(np.asarray(on_card[k]),
                              np.asarray(on_host[k])), k


def test_default_policy_runs_latency_bound_sweeps_in_float64(card,
                                                             monkeypatch):
    """Under the card's default policy the dispatches of lu N=10's sweep
    run the float64 pass alone, nothing is certified, and the answers
    equal the host's bit for bit.  The float32 policy named explicitly
    still certifies, and demotes the 0.1 column."""
    alphas = [50.0, 125.0, 0.1, 300.0]
    got = {}
    for dtype in (None, "float32"):
        B.reset_stats()
        got[dtype] = sweep_report(polybench.trace_kernel("lu", 10), alphas,
                                  simulate_points=True, compute_slots=8,
                                  replay_dtype=dtype)
        st = B.stats.snapshot()
        assert st["cuda_chunks"] > 0 and st["cpu_chunks"] == 0
        assert st["cuda_f64_chunks"] == 0
        if dtype is None:
            assert st["latency_bound_chunks"] > 0
            assert st["certified_columns"] == 0
        else:
            assert st["latency_bound_chunks"] == 0
            assert st["certified_columns"] >= 1
            assert st["demoted_columns"] >= 1     # the 0.1 column
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    on_host = sweep_report(polybench.trace_kernel("lu", 10), alphas,
                           simulate_points=True, compute_slots=8)
    for dtype, on_card in got.items():
        for k in on_host:
            assert np.array_equal(np.asarray(on_card[k]),
                                  np.asarray(on_host[k])), (dtype, k)


# ------------------------------------------------ recurrence kernels (K2, K3)

def _rel(a, b):
    return ((a.double() - b.double()).abs().max() /
            b.double().abs().max()).item()


#: lengths that reach both code paths of K2 (token steps below 16, blocks
#: of 16 with a ragged tail above) and of K3 (below 64, blocks of 64)
REC_T = [1, 15, 16, 17, 37, 50, 128, 200, 1024]


def _wkv6_args(card, T, seed, fault=False):
    g = torch.Generator(device=card).manual_seed(seed)
    B, H, K, V = 2, 3, 64, 64
    r, k, v = (torch.randn(B, H, T, n, generator=g, device=card)
               for n in (K, K, V))
    w = (torch.full((B, H, T, K), float(np.exp(-1.0)), device=card) if fault
         else torch.rand(B, H, T, K, generator=g, device=card) * 0.5 + 0.45)
    u = torch.randn(H, K, generator=g, device=card) * 0.1
    s0 = torch.randn(B, H, K, V, generator=g, device=card) * 0.1
    return r, k, v, w, u, s0


def _ssd_args(card, T, G, seed, fault=False):
    g = torch.Generator(device=card).manual_seed(seed)
    B, H, P, N = 2, 4, 64, 64
    x = torch.randn(B, H, T, P, generator=g, device=card)
    if fault:
        dt = torch.full((B, H, T), 0.7, device=card)
        A = -torch.ones(H, device=card)
    else:
        dt = torch.rand(B, H, T, generator=g, device=card)
        A = -torch.rand(H, generator=g, device=card) - 0.5
    Bm, Cm = (torch.randn(B, G, T, N, generator=g, device=card) * 0.4
              for _ in range(2))
    D = torch.randn(H, generator=g, device=card)
    s0 = torch.randn(B, H, P, N, generator=g, device=card) * 0.1
    return x, dt, A, Bm, Cm, D, s0


def _one_launch(kernel, args):
    """One call of ``kernel``: it must launch exactly one grid and give
    finite outputs."""
    n0 = kernel.launches
    y, S = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    return y, S


@pytest.mark.parametrize("T", REC_T)
def test_wkv6_kernel_vs_plain(card, T):
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6 import wkv6
    args = _wkv6_args(card, T, seed=T)
    y, S = _one_launch(wkv6, args)
    yp, Sp = ref.wkv6_ref(*args)
    assert _rel(y, yp) < 1e-5 and _rel(S, Sp) < 1e-5


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("T", REC_T)
def test_ssd_kernel_vs_plain(card, T, G):
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd import ssd
    args = _ssd_args(card, T, G, seed=T + G)
    y, S = _one_launch(ssd, args)
    yp, Sp = ref.ssd_ref(*args)
    assert _rel(y, yp) < 1e-5 and _rel(S, Sp) < 1e-5


@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
def test_recurrence_kernels_fault1(card, kind):
    """T=256 with decay e^-1 (WKV6) or dt=0.7, A=-1 (SSD), on which the TPU
    kernels' exp(-cs) overflows: finite and within 1e-5 of the sequential
    plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    if kind == "wkv6":
        args = _wkv6_args(card, 256, seed=7, fault=True)
        y, S = _one_launch(wkv6, args)
        yp, Sp = ref.wkv6_ref(*args)
    else:
        args = _ssd_args(card, 256, 1, seed=7, fault=True)
        y, S = _one_launch(ssd, args)
        yp, Sp = ref.ssd_ref(*args)
    assert _rel(y, yp) < 1e-5 and _rel(S, Sp) < 1e-5


@pytest.mark.parametrize("T", [15, 37, 200])
@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
def test_recurrence_kernels_odd_widths_and_offsets(card, kind, T):
    """State widths that are not a multiple of 4 (V, P = 30: the kernels'
    4-byte copies) and inputs that do not start on 16 bytes (contiguous
    views one float into a buffer, which the wrappers copy): one launch,
    within 1e-5 of the sequential plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6

    def offset(t):
        buf = torch.empty(t.numel() + 1, device=card)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view
    if kind == "wkv6":
        a = list(_wkv6_args(card, T, seed=T))
        a[2] = torch.randn(2, 3, T, 30, device=card)
        a[5] = torch.randn(2, 3, 64, 30, device=card) * 0.1
        kernel, plain = wkv6, ref.wkv6_ref
    else:
        a = list(_ssd_args(card, T, 2, seed=T))
        a[0] = torch.randn(2, 4, T, 30, device=card)
        a[6] = torch.randn(2, 4, 30, 64, device=card) * 0.1
        kernel, plain = ssd, ref.ssd_ref
    a = [offset(t) if t.dim() == 4 else t for t in a]
    assert all(t.data_ptr() % 16 for t in a if t.dim() == 4)
    y, S = _one_launch(kernel, a)
    yp, Sp = plain(*a)
    assert _rel(y, yp) < 1e-5 and _rel(S, Sp) < 1e-5


def test_recurrence_wrappers_reject_bad_inputs(card):
    from repro_torch.kernels.wkv6 import wkv6
    z = torch.zeros(1, 2, 4, 64, device=card)
    u, s0 = torch.zeros(2, 64, device=card), torch.zeros(1, 2, 64, 64,
                                                          device=card)
    with pytest.raises(ValueError, match="float32"):
        wkv6(z.double(), z, z, z, u, s0)
    with pytest.raises(ValueError, match="contiguous"):
        wkv6(z.transpose(2, 3).contiguous().transpose(2, 3), z, z, z, u, s0)
    with pytest.raises(ValueError, match="K in"):
        zk = torch.zeros(1, 2, 4, 48, device=card)
        wkv6(zk, zk, z, zk, torch.zeros(2, 48, device=card),
             torch.zeros(1, 2, 48, 64, device=card))


def test_serving_on_the_card_launches_the_kernels(card):
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch import serve
    for name, kern in (("rwkv6-7b", wkv6), ("zamba2-7b", ssd)):
        cfg = ARCHS[name].reduced()
        n0 = kern.launches
        res = serve.run(cfg, requests=3, slots=2, max_seq=32, max_tokens=4,
                        device="cuda", emit=lambda s: None)
        steps = res["stats"]["prefills"] + res["stats"]["decode_steps"]
        assert kern.launches - n0 == cfg.n_layers * steps
        assert res["tokens"] == 12


# ------------------------------------------------------ flash attention (K4)

#: K4 against its plain version (same float32 online softmax, other
#: summation order): relative to the largest |plain| value, 1e-5 in
#: float32; in bf16 one rounding of the output, 2^-7.
ATT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,S,H,KV,hd,causal,window", [
    (128, 128, 16, 8, 128, True, 0), (128, 128, 16, 8, 64, True, 0),
    (200, 200, 4, 2, 112, True, 0), (256, 256, 4, 4, 96, True, 64),
    (128, 384, 4, 2, 64, False, 0), (37, 37, 4, 1, 16, True, 0)])
def test_flash_attention_kernel_vs_plain(card, dtype, T, S, H, KV, hd,
                                         causal, window):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_plain
    g = torch.Generator(device=card).manual_seed(T + hd)
    q = torch.randn(2, T, H, hd, generator=g, device=card).to(dtype)
    k, v = (torch.randn(2, S, KV, hd, generator=g, device=card).to(dtype)
            for _ in range(2))
    n0 = flash_attention.launches
    o = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == n0 + 1
    torch.cuda.synchronize()
    assert o.dtype == dtype and torch.isfinite(o).all()
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 block_kv=64)
    assert _rel(o, want) < ATT_TOL[dtype]


def test_flash_attention_reads_strides(card):
    """Views with permuted strides give the contiguous inputs' result."""
    from repro_torch.kernels.flash_attention import flash_attention
    g = torch.Generator(device=card).manual_seed(5)
    qt = torch.randn(2, 4, 96, 64, generator=g, device=card)    # (B,H,T,hd)
    kt = torch.randn(2, 2, 96, 64, generator=g, device=card)
    vt = torch.randn(2, 2, 96, 64, generator=g, device=card)
    views = [t.transpose(1, 2) for t in (qt, kt, vt)]
    assert not views[0].is_contiguous()
    a = flash_attention(*views)
    b = flash_attention(*(t.contiguous() for t in views))
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_unaligned_strides(card, dtype):
    """Views whose strides and base are not 16-byte aligned (the bf16
    kernel then loads element by element) give the contiguous inputs'
    result bit for bit."""
    from repro_torch.kernels.flash_attention import flash_attention
    g = torch.Generator(device=card).manual_seed(6)
    wide = [torch.randn(2, 80, 4, 41, generator=g, device=card).to(dtype)
            for _ in range(3)]
    views = [t[..., 1:] for t in wide]                   # hd=40, odd strides
    assert views[0].stride(1) % 8 and views[0].data_ptr() % 16
    a = flash_attention(*views, causal=True, window=24)
    b = flash_attention(*(t.contiguous() for t in views), causal=True,
                        window=24)
    assert torch.equal(a, b)


def test_serving_transformers_on_the_card_launch_k4(card):
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve
    for name in ("qwen3-0.6b", "granite-moe-1b-a400m", "internvl2-2b"):
        cfg = ARCHS[name].reduced()
        n0 = flash_attention.launches
        res = serve.run(cfg, requests=3, slots=2, max_tokens=4,
                        device="cuda", emit=lambda s: None)
        assert flash_attention.launches - n0 == \
            cfg.n_layers * res["stats"]["prefills"]
        assert res["tokens"] == 12


# -------------------------------- K1's plan on the card: wide and narrow

def _layered_port_dag(widths, seed=0):
    """Layers of the given widths, each vertex fed by one to three of the
    layer before (the port's EDag)."""
    from repro_torch.core.graph import EDag
    rng = np.random.default_rng(seed)
    src, dst, prev, n = [], [], [], 0
    for w in widths:
        cur = list(range(n, n + w))
        for v in cur:
            if prev:
                for u in rng.choice(prev, size=min(len(prev), int(
                        rng.integers(1, 4))), replace=False):
                    src.append(int(u))
                    dst.append(v)
        prev, n = cur, n + w
    is_mem = rng.random(n) < 0.5
    return EDag.from_arrays(np.ones(n), is_mem, np.where(is_mem, 8.0, 0.0),
                            np.asarray(src, dtype=np.int64),
                            np.asarray(dst, dtype=np.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("slot", [False, True])
def test_kernel_plan_mixing_wide_and_narrow_levels(card, dtype, slot):
    """k = 11 columns (two column tiles of the segment kernel) over levels
    of 2 to 600 vertices: narrow stretches in one launch each, wide levels
    alone; bitwise equal to the plain version, one grid per plan row."""
    from repro_torch.kernels.level_step import narrow_width
    g = _layered_port_dag((5, 600, 3, 2, 7, 400, 1, 300, 4, 4))
    g._finalize()
    if slot:
        # 300 slots of each kind keep the wide levels wide
        _, plan_ = S._record_plan(g, g._sim_lists(), 300, 300, 50.0, 1.0,
                                  persist=False)
        lv = plan_.lv
    else:
        lv = g._level_csr()
    k = 11
    plan = lv.level_plan(narrow_width(k))
    assert plan[:, 2].any() and not plan[:, 2].all()
    rows = lv.n + (1 if slot else 0)
    base = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (rows, k)) * 50).to(card, dtype)
    if slot:
        base[-1] = 0
    for clamp in (False, True):
        Fk, Fp = base.clone(), base.clone()
        Rk, Rp = torch.zeros_like(base), torch.zeros_like(base)
        n0, v0 = level_step.launches, level_step.levels
        level_step(lv, Fk, clamp=clamp, R_out=Rk)
        assert level_step.launches - n0 == len(plan)
        assert level_step.levels - v0 == int(plan[:, 3].sum())
        level_step_plain(lv, Fp, clamp=clamp, R_out=Rp)
        torch.cuda.synchronize()
        assert torch.equal(_bits(Fk), _bits(Fp))
        assert torch.equal(_bits(Rk), _bits(Rp))


def test_kernel_replay_plan_is_one_launch(card):
    """A replay plan's levels are all narrow: one grid per call."""
    g, plan = _plan()
    base = torch.ones((plan.lv.n + 1, 11), device=card)
    base[-1] = 0
    n0 = level_step.launches
    level_step(plan.lv, base)
    assert level_step.launches - n0 == 1


# ------------------------------------- bf16 K4 against both plain versions

#: bf16 K4 against the plain version that rounds P to bf16 as the kernel
#: does: within one bf16 ulp of each output (2^-7 of it: the float32 sums
#: run in another order, which can flip the output's rounding) plus 2^-10
#: of the largest (the same can flip a probability's rounding).
ROUND_P_TOL = (2.0 ** -7, 2.0 ** -10)


@pytest.mark.parametrize("B,T,S,H,KV,hd,causal,window", [
    (2, 64, 64, 4, 2, 8, True, 0), (1, 64, 64, 4, 4, 40, True, 0),
    (1, 128, 128, 4, 2, 112, True, 0), (1, 128, 128, 4, 2, 64, True, 32),
    (2, 32, 96, 4, 1, 40, False, 0), (1, 37, 37, 4, 2, 16, True, 0)])
def test_bf16_kernel_vs_both_plain_versions(card, B, T, S, H, KV, hd,
                                            causal, window):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_plain
    g = torch.Generator(device=card).manual_seed(T + hd)
    q = torch.randn(B, T, H, hd, generator=g, device=card).bfloat16()
    k, v = (torch.randn(B, S, KV, hd, generator=g,
                        device=card).bfloat16() for _ in range(2))
    o = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and torch.isfinite(o).all()
    plain = flash_attention_plain(q, k, v, causal=causal, window=window,
                                  block_kv=128)
    assert _rel(o, plain) < ATT_TOL[torch.bfloat16]
    rounded = flash_attention_plain(q, k, v, causal=causal, window=window,
                                    block_kv=128, round_p=True)
    rtol, atol = ROUND_P_TOL
    err = (o.double() - rounded.double()).abs()
    assert (err <= rtol * rounded.double().abs() +
            atol * rounded.double().abs().max()).all()


def _suite(names=("gemm", "atax", "lu"), N=8, classes=False):
    from repro_torch.core import EDagSuite, object_class_map
    from repro_torch.core import objects_from_edag
    members = [polybench.trace_kernel(nm, N) for nm in names]
    if classes:
        for g in members:
            g.set_mem_classes(object_class_map(g, objects_from_edag(g)))
    return EDagSuite(members, names=list(names))


#: ten PAPER_15 members over six pairs: blocks enough side by side that
#: the union's plan holds wide-level grids between its narrow segments
WIDE_SUITE = tuple(nm for nm in polybench.PAPER_15
                   if nm not in ("2mm", "3mm", "doitgen", "gemm", "symm"))
WIDE_PAIRS = [(2, 0), (2, 8), (4, 0), (4, 8), (8, 0), (8, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("classes", [False, True])
@pytest.mark.parametrize("wide", [False, True])
def test_kernel_bitwise_on_union_and_class_plans(card, dtype, classes, wide):
    """K1 on a union replay plan (``seg_ptr`` blocks interleaving per
    level) and on a class-mode union plan (provenance slot chains), the
    wide ones with wide-level grids in their plans: equal to the plain
    version bit for bit, one grid per plan row."""
    from repro_torch.core import suite as SU
    from repro_torch.kernels.level_step import narrow_width
    suite = _suite(WIDE_SUITE, classes=classes) if wide else \
        _suite(classes=classes)
    pairs = WIDE_PAIRS if wide else [(2, 0), (4, 8)]
    width = max(g.n_mem_classes() for g in suite.members)
    a0 = np.full(width, 200.0) if classes else 50.0
    plan = SU._build_suite_plan(suite, pairs, 1.0, a0, False,
                                n_classes=width if classes else None)
    lv = plan.lv
    n_blocks = len(pairs) * len(suite.members)
    assert lv.seg_ptr is not None and len(lv.seg_ptr) == n_blocks + 1
    assert (lv.level_plan(narrow_width(7))[:, 2] != 0).any() == wide
    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.integers(1, 400, (lv.n + 1, 7)) / 4.0
                            ).to(card, dtype)
    base[-1] = 0
    Fk, Fp = base.clone(), base.clone()
    Rk, Rp = torch.zeros_like(base), torch.zeros_like(base)
    n0 = level_step.launches
    level_step(lv, Fk, clamp=False, R_out=Rk)
    assert level_step.launches - n0 == len(lv.level_plan(narrow_width(7)))
    level_step_plain(lv, Fp, clamp=False, R_out=Rp)
    torch.cuda.synchronize()
    assert torch.equal(_bits(Fk), _bits(Fp))
    assert torch.equal(_bits(Rk), _bits(Rp))


@pytest.mark.parametrize("classes", [False, True])
def test_suite_grid_on_card_equals_member_grids(card, classes):
    from repro_torch.core import suite as SU
    from repro_torch.core import suite_sweep_grid, sweep_grid
    suite = _suite(classes=classes)
    if classes:
        width = max(g.n_mem_classes() for g in suite.members)
        alphas = np.full((3, width), 200.0)
        alphas[1] = 1.0
        alphas[2, 0] = 1.0
    else:
        alphas = np.linspace(50.0, 300.0, 6)
    B.reset_stats()
    SU.stats.reset()
    got = suite_sweep_grid(suite, alphas, ms=(2, 4), compute_slots=(0, 8))
    assert B.stats["cuda_chunks"] > 0 and B.stats["cpu_chunks"] == 0
    fallbacks = SU.stats["fallback_points"]
    for k, g in enumerate(suite.members):
        assert np.array_equal(got[k], sweep_grid(g, alphas, ms=(2, 4),
                                                 compute_slots=(0, 8)))
    SU.stats.reset()
    host = suite_sweep_grid(_suite(classes=classes), alphas, ms=(2, 4),
                            compute_slots=(0, 8), backend="cpu")
    assert np.array_equal(got, host)
    # the card's union replays certified what the host's did
    assert SU.stats["fallback_points"] == fallbacks


def test_search_placement_on_card_equals_host(card):
    from repro_torch.core import objects_from_edag, search_placement
    g = polybench.trace_kernel("atax", 8)
    budget = sum(o.nbytes for o in objects_from_edag(g)) // 2
    reps = {}
    for backend in ("cuda", "cpu"):
        B.reset_stats()
        reps[backend] = [search_placement(g, 1.0, 200.0, budget, m=4,
                                          method=method, backend=backend)
                         for method in ("oracle", "greedy")]
        assert B.stats[f"{backend}_chunks"] > 0
    for a, b in zip(reps["cuda"], reps["cpu"]):
        assert (a.local, a.makespan, a.all_local, a.all_remote,
                a.marginal) == (b.local, b.makespan, b.all_local,
                                b.all_remote, b.marginal)
        assert np.array_equal(a.curve, b.curve)


# ----------------------------------------------- persistence and the service

def _service_requests(backend, names=("atax", "bicg", "mvt")):
    from repro_torch.serve import AnalysisRequest
    return [AnalysisRequest(kernel=nm, n=8, alphas=(60.0, 120.0, 240.0),
                            ms=(2, 4), backend=backend) for nm in names]


def _same_reports(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()
        for k in a)


def test_service_answers_on_rung_0_on_the_card(card, tmp_path, monkeypatch):
    """A union batch answered on the level kernel on the card, at rung 0
    (no dtype named: one float64 pass a chunk), equal bit for bit to the
    host's answers."""
    from repro_torch.serve import AnalysisService, faults
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", str(tmp_path))
    faults.reset()
    B.reset_stats()
    launches = level_step.launches
    out = AnalysisService(start=False, backoff_s=0.0).process(
        _service_requests(None))
    assert all(r.ok for r in out) and len(out[0].batch_rids) == 3
    for r in out:
        assert r.policy == {"backend": "cuda", "replay_dtype": None,
                            "demotions": 0}
    assert B.stats["cuda_chunks"] > 0 and B.stats["cpu_chunks"] == 0
    assert B.stats["latency_bound_chunks"] == B.stats["chunks"]
    assert level_step.launches > launches
    host = AnalysisService(start=False, backoff_s=0.0).process(
        _service_requests("cpu"))
    for a, b in zip(out, host):
        assert _same_reports(a.report, b.report)


def test_kernel_fault_demotes_visibly(card, tmp_path, monkeypatch):
    """A fault inside the level kernel's dispatch reaches the service's
    replay stage: the request ends on float64 on the card, one rung down,
    with its demotion recorded, and its answer is the clean one."""
    from repro_torch.serve import AnalysisService, faults
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", str(tmp_path))
    faults.reset()
    try:
        (clean,) = AnalysisService(start=False, backoff_s=0.0).process(
            _service_requests(None, ("atax",)))
        faults.install("kernel", "backend", count=1)
        (res,) = AnalysisService(start=False, backoff_s=0.0).process(
            _service_requests(None, ("atax",)))
        assert faults.fire_log[("kernel", "backend")] == 1
    finally:
        faults.reset()
    assert res.ok and res.retries == 1
    assert res.policy == {"backend": "cuda", "replay_dtype": "float64",
                          "demotions": 1}
    assert _same_reports(res.report, clean.report)


def test_format4_warm_replay_from_mapped_entries(card, tmp_path,
                                                 monkeypatch):
    """A warm process's plans come from read-only memory-mapped format-4
    entries (and its trace from the trace store), copied once into device
    tensors: no warning, no recording, the cold grid's bits."""
    import warnings
    from repro_torch.core import load_edag, save_edag, sweep_grid
    from repro_torch.core import schedule_cache as sc
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", str(tmp_path / "sched"))
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MIN", "0")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE_MMAP_MIN", "0")
    alphas = np.array([50.0, 150.0, 300.0])
    g = polybench.trace_kernel("gemm", 10)
    cold = sweep_grid(g, alphas, ms=(2, 4), compute_slots=(0, 8))
    assert len(list((tmp_path / "sched").glob("*.d"))) == 4
    path = save_edag(g, tmp_path / "trace")
    del g
    sc.reset_stats()
    B.reset_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        warm = sweep_grid(load_edag(path), alphas, ms=(2, 4),
                          compute_slots=(0, 8))
    assert sc.stats["disk_hits"] == 4 and sc.stats["record_runs"] == 0
    assert B.stats["cuda_chunks"] > 0 and B.stats["cpu_chunks"] == 0
    assert np.asarray(cold).tobytes() == np.asarray(warm).tobytes()


# ------------------------------------------------------------- frontends

def _rel_np(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("name", list(polybench.TORCH_KERNELS))
def test_polybench_twins_on_card_equal_host(card, name):
    args = polybench.twin_inputs(name, 20)
    fn = polybench.TORCH_KERNELS[name]
    dev = fn(*[torch.from_numpy(a).to(card) for a in args])
    host = polybench.twin_numpy(name, args)
    dev = dev if isinstance(dev, tuple) else (dev,)
    for d, h in zip(dev, host):
        assert d.device.type == "cuda"
        assert _rel_np(d.cpu().numpy(), h) < 1e-12


def test_cg_and_lulesh_twins_on_card(card):
    from repro_torch.apps import hpcg, lulesh
    _, hist_ref = hpcg.reference_solution(16, 6)
    b = torch.from_numpy(hpcg.build_problem(16)).to(card)
    _, hist = hpcg.cg_torch(b, 16, 6)
    assert hist.device.type == "cuda"
    assert _rel_np(hist.cpu().numpy(), hist_ref) < 1e-10
    dev_state, dev_hist = lulesh.run_torch(10, 3, device=card)
    host_state, host_hist = lulesh.run_torch(10, 3, device="cpu")
    ref_state, ref_hist = lulesh.lulesh_numpy(10, 3)
    for d, h, r in zip(dev_state + (dev_hist,), host_state + (host_hist,),
                       ref_state + (ref_hist,)):
        assert _rel_np(d.cpu().numpy(), h.numpy()) < 1e-12
        assert _rel_np(d.cpu().numpy(), r) < 1e-12
    # with no device named, the twin takes the card
    assert lulesh.run_torch(3, 1)[1].device.type == "cuda"


@pytest.mark.parametrize("name", ["gemm", "trisolv"])
def test_twin_edag_is_device_independent(card, name):
    from repro_torch.core import edag_from_fn
    args = polybench.twin_inputs(name, 12)
    graphs = []
    for device in ("cuda", "cpu", "meta"):
        g = edag_from_fn(polybench.TORCH_KERNELS[name], *[
            torch.tensor(a, dtype=torch.float32, device=device)
            for a in args])
        g.trace_digest()
        graphs.append((g.trace_digest(), list(g.labels()), g.cost.tolist(),
                       g.nbytes.tolist()))
    assert graphs[0] == graphs[1] == graphs[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("slot", [False, True])
def test_kernel_bitwise_on_cg_twin_plan(card, dtype, slot):
    """K1 against its plain version on the CG twin's eDAG (n=6, 3
    iterations) and its replay plan (m=4, 8 ALU slots)."""
    from repro_torch.apps import hpcg
    from repro_torch.core import edag_from_fn
    from repro_torch.core import scheduler as S
    g = edag_from_fn(lambda b: hpcg.cg_torch(b, 6, 3),
                     torch.empty(216, device="meta"))
    g._finalize()
    _, plan = S._record_plan(g, g._sim_lists(), 4, 8, 50.0, 1.0,
                             persist=False)
    lv = plan.lv if slot else g._level_csr()
    rows = lv.n + (1 if slot else 0)
    base = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (rows, 13)) * 100.0).to(card, dtype)
    if slot:
        base[-1] = 0
    for want_r in (False, True):
        Fk, Fp = base.clone(), base.clone()
        Rk = torch.zeros_like(base) if want_r else None
        Rp = torch.zeros_like(base) if want_r else None
        n0 = level_step.launches
        level_step(lv, Fk, clamp=True, R_out=Rk)
        assert level_step.launches > n0
        level_step_plain(lv, Fp, clamp=True, R_out=Rp)
        torch.cuda.synchronize()
        assert torch.equal(_bits(Fk), _bits(Fp))
        if want_r:
            assert torch.equal(_bits(Rk), _bits(Rp))


def test_collective_sensitivity_on_card_equals_expected(card):
    import gzip
    import json
    from pathlib import Path
    from repro_torch.core import collective_sensitivity
    cfg = Path(polybench.__file__).resolve().parents[1] / "configs"
    want = json.loads((cfg / "frontend_expected.json").read_text())["hlo"]
    text = gzip.decompress((cfg / "hlo" / "train.hlo.gz").read_bytes())
    n0 = level_step.launches
    got = collective_sensitivity(text.decode(), [("data", 2), ("model", 4)],
                                 m=4)
    assert level_step.launches > n0
    rows = {k: v.row() for k, v in got["per_axis"].items()}
    assert json.loads(json.dumps(dict(per_axis=rows, raw=got["raw"]))) == \
        want["train"]["collective_sensitivity"]


# ------------------------------------ encoder-decoder and model-zoo tracing

def test_serving_encdec_on_the_card_launches_k4(card):
    """The reduced seamless-m4t served on the card: K4 once per encoder
    layer and twice per decoder layer in every prefill, never in decode."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve
    cfg = ARCHS["seamless-m4t-large-v2"].reduced()
    n0 = flash_attention.launches
    res = serve.run(cfg, requests=3, slots=2, max_tokens=4, device="cuda",
                    emit=lambda s: None)
    assert flash_attention.launches - n0 == \
        (cfg.n_enc_layers + 2 * cfg.n_layers) * res["stats"]["prefills"]
    assert res["tokens"] == 12


@pytest.mark.parametrize("frames", [12, 20])
def test_encdec_prefill_on_card_equals_host(card, frames):
    """The reduced seamless-m4t's prefill (float32) over 12 tokens and
    ``frames`` frames on the card (K4, the cross-attention with T != S at
    20 frames) against the host's plain path: logits and every cache leaf
    within 1e-4 of their largest magnitude."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import get_model
    from repro_torch.models.module import tree_map
    api = get_model(ARCHS["seamless-m4t-large-v2"].reduced())
    p = api.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    g = torch.Generator().manual_seed(1)
    batch = dict(tokens=torch.randint(0, 256, (2, 12), generator=g),
                 frame_embeds=torch.randn((2, frames, api.cfg.d_model),
                                          generator=g))
    with torch.inference_mode():
        lh, sh = api.prefill_fn(p, batch, cache_len=16)
        lc, sc = api.prefill_fn(tree_map(lambda t: t.to(card), p),
                                tree_map(lambda t: t.to(card), batch),
                                cache_len=16)
    assert _rel(lc.cpu(), lh) < 1e-4
    for key in sh:
        assert _rel(sc[key].cpu(), sh[key]) < 1e-4, key


def test_cuda_kernels_refuse_autograd(card):
    """The kernels have no backward: a CUDA call that autograd would
    differentiate raises instead of returning a detached result."""
    from repro_torch.kernels import ops
    q = torch.randn(1, 8, 2, 16, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, q.detach(), q.detach())
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).shape == q.shape


def test_model_tracing_on_the_card_runs_no_kernel(card):
    """``trace_model`` with the card selected traces from meta tensors:
    no model kernel launches, and the eDAG is the host's."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.models import tracing
    n0 = (flash_attention.launches, wkv6.launches)
    for name in ("qwen3-0.6b", "rwkv6-7b"):
        g = tracing.trace_model(name, "prefill", use_store=False)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("EDAN_TORCH_BACKEND", "cpu")
            h = tracing.trace_model(name, "prefill", use_store=False)
        assert g.trace_digest() == h.trace_digest()
    assert (flash_attention.launches, wkv6.launches) == n0


def test_model_request_on_rung_0_on_the_card(card, tmp_path, monkeypatch):
    """A model request answered on the level kernel on the card at rung
    0, equal bit for bit to the host's answer."""
    from repro_torch.serve import AnalysisRequest, AnalysisService, faults
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", str(tmp_path))
    faults.reset()

    def request(backend):
        return AnalysisRequest(config="qwen3-0.6b", kind="model",
                               phase="decode", alphas=(60.0, 140.0),
                               ms=(2, 4), backend=backend)
    launches = level_step.launches
    (res,) = AnalysisService(start=False, backoff_s=0.0).process(
        [request(None)])
    assert res.ok and res.policy == {"backend": "cuda",
                                     "replay_dtype": None,
                                     "demotions": 0}
    assert level_step.launches > launches
    (host,) = AnalysisService(start=False, backoff_s=0.0).process(
        [request("cpu")])
    assert _same_reports(res.report, host.report)


def test_training_route_differentiates_on_the_card(card):
    """Inside ``ops.differentiable()`` a CUDA call that autograd
    differentiates takes the plain version (no K4 launch) and its gradient
    is the host's; outside it the same call still raises."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn(1, 8, 2, 16, generator=torch.Generator().manual_seed(0))
    grads = {}
    for dev in ("cpu", "cuda"):
        x = q.to(dev, copy=True).requires_grad_(True)
        n0 = flash_attention.launches
        with ops.differentiable():
            ops.flash_attention(x, x, x, block_kv=4).sum().backward()
        assert flash_attention.launches == n0
        grads[dev] = x.grad.cpu()
    assert torch.allclose(grads["cuda"], grads["cpu"], rtol=1e-4, atol=1e-5)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q.to(card).requires_grad_(True), q.to(card),
                            q.to(card))


def test_train_step_on_the_card_matches_the_host_and_launches_nothing(card):
    """One train step of reduced qwen3-0.6b and zamba2-7b on the card: the
    host's loss and parameters (TF32 off), and none of the model kernels
    launched."""
    from repro_torch.configs import ARCHS, TrainConfig
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd import ssd
    from repro_torch.models import get_model
    from repro_torch.models.module import (init_params_numpy,
                                           params_from_numpy, tree_leaves)
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_loop import make_train_step
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name in ("qwen3-0.6b", "zamba2-7b"):
            api = get_model(ARCHS[name].reduced())
            npp = init_params_numpy(api.specs(), 0)
            rng = np.random.default_rng(1)
            nb = {k: rng.integers(0, 256, (2, 16)).astype(np.int32)
                  for k in ("tokens", "labels")}
            step = make_train_step(api, TrainConfig(warmup_steps=0))
            out = {}
            n0 = (flash_attention.launches, ssd.launches)
            for dev in ("cpu", "cuda"):
                p = params_from_numpy(npp, dev)
                b = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
                p2, _, m = step(p, adamw_init(p), b)
                out[dev] = (float(m["loss"]), [x.cpu() for x in
                                               tree_leaves(p2)])
            assert (flash_attention.launches, ssd.launches) == n0
            assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * out["cpu"][0]
            for a, b in zip(out["cuda"][1], out["cpu"][1]):
                assert a.device.type == "cpu"
                assert torch.allclose(a, b, rtol=2e-3, atol=2e-3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
