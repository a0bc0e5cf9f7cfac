"""The level kernels' launch plan (``LevelCSR.level_plan``) and the plain
version run plan row by plan row, against the JAX package's reference
numpy kernel (``repro.core.backend._accumulate_numpy``).

On the card each narrow row of the plan is one launch of the segment
kernel and each wide level one launch of the per-level kernel; here the
plain version runs the same rows one after another.  Max is exact and each
finish is one IEEE add, so every comparison is bitwise.  Data is made with
numpy from a seed and handed to both packages.
"""
import numpy as np
import pytest
import torch

import repro.core.backend as rbk
from repro.core import EDag as REDag
from repro.core import scheduler as rsched
import repro_torch.core.backend as tbk
from repro_torch.kernels.level_step import (COLUMN_TILE, level_step,
                                            level_step_plain, narrow_width)


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


def _layered_edag(seed: int, widths=(3, 40, 2, 2, 60, 1, 5, 30)) -> REDag:
    """Layers of the given widths, each vertex fed by one to three of the
    layer before: wide and narrow levels alternate."""
    rng = np.random.default_rng(seed)
    g = REDag()
    prev = []
    for w in widths:
        cur = []
        for _ in range(w):
            v = g.add_vertex(cost=float(rng.integers(1, 5)),
                             is_mem=bool(rng.random() < 0.5))
            if prev:
                for u in rng.choice(prev, size=min(len(prev),
                                                   int(rng.integers(1, 4))),
                                    replace=False):
                    g.add_edge(int(u), v)
            cur.append(v)
        prev = cur
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


def _lv(kind: str, seed: int):
    """A reference level partition: a random DAG's, a layered DAG's, or
    the replay plan of either (slot chains and queue-only vertices)."""
    g = _layered_edag(seed) if kind.startswith("layered") else \
        _random_edag(seed)
    if kind.endswith("replay"):
        _, plan = rsched._record_plan(g, g._sim_lists(), 2, 3, 40.0, 1.0,
                                      persist=False)
        return plan.lv
    return g._level_csr()


KINDS = ["random", "random replay", "layered", "layered replay"]


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


# ------------------------------------------------------------------ plan

def _check_plan(lv, narrow: int) -> np.ndarray:
    plan = lv.level_plan(narrow)
    w = lv.level_widths()
    assert plan.dtype == np.int32 and plan.ndim == 2 and plan.shape[1] == 4
    covered = []
    for l0, l1, wide, levels in plan.tolist():
        assert 1 <= l0 < l1 <= lv.n_levels
        span = w[l0:l1]
        if wide:
            assert l1 == l0 + 1 and span[0] > narrow
        else:
            # a narrow row starts and ends on a level with work
            assert (span <= narrow).all() and span[0] > 0 and span[-1] > 0
        assert levels == int((span > 0).sum())
        covered += [lv_ for lv_ in range(l0, l1) if w[lv_] > 0]
    # every non-empty level once, in order
    assert covered == [x for x in range(1, lv.n_levels) if w[x] > 0]
    # narrow rows are maximal: between two of them lies a wide level
    for (a0, a1, aw, _), (b0, b1, bw, _) in zip(plan[:-1].tolist(),
                                                plan[1:].tolist()):
        assert a1 <= b0
        if not aw and not bw:
            assert (w[a1:b0] > narrow).any()
    return plan


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("narrow", [0, 1, 2, 5, 40, 10 ** 6])
def test_plan_covers_every_level_once_in_order(kind, seed, narrow):
    lv = port_csr(_lv(kind, seed))
    _check_plan(lv, narrow)


def test_plan_mixes_wide_and_narrow_and_is_memoized():
    lv = port_csr(_lv("layered", 0))
    plan = _check_plan(lv, 10)
    assert plan[:, 2].any() and not plan[:, 2].all()
    assert lv.level_plan(10) is plan
    assert lv.level_plan(11) is not plan
    # one narrow row when every level is narrow, only wide rows when none
    every = lv.level_plan(10 ** 6)
    assert len(every) == 1 and every[0, 2] == 0
    assert lv.level_plan(0)[:, 2].all()


def test_plan_follows_slot_chain_attachment():
    """Attaching slot chains (queue-only vertices) widens levels: the
    memoized plan is not reused across the attachment."""
    g = _random_edag(3)
    _, rplan = rsched._record_plan(g, g._sim_lists(), 2, 3, 40.0, 1.0,
                                   persist=False)
    lv = port_csr(rplan.lv)
    qonly_ptr = lv.qonly_ptr
    assert qonly_ptr is not None
    with_q = lv.level_plan(1).copy()
    lv.qonly_ptr = None
    without = lv.level_plan(1)
    lv.qonly_ptr = qonly_ptr
    assert np.array_equal(lv.level_plan(1), with_q)
    assert with_q[:, 3].sum() >= without[:, 3].sum()


def test_plan_of_a_partition_without_work():
    lv = tbk.build_level_partition(np.zeros(0, np.int32),
                                   np.zeros(0, np.int32),
                                   np.zeros(3, np.int64), 3)
    assert lv.level_plan(narrow_width(4)).shape == (0, 4)


@pytest.mark.parametrize("k,want", [(1, 2048), (2, 1024), (8, 256),
                                    (11, 256), (500, 256)])
def test_narrow_width_counts_a_column_tile(k, want):
    assert narrow_width(k) == want
    assert narrow_width(k) * min(k, COLUMN_TILE) <= 2048


# ------------------------------------------------ plain version by rows

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("want_r", [False, True])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_by_plan_rows_is_bitwise_the_reference(kind, clamp, want_r,
                                                     dtype):
    """The plain version run row by row of a mixed plan equals the whole
    pass and the reference numpy kernel bit for bit (dirty bases: both
    signs, signed zeros, a NaN)."""
    ref_lv = _lv(kind, 2)
    lv = port_csr(ref_lv)
    slot = lv.qpred is not None
    rng = np.random.default_rng(11)
    rows = lv.n + (1 if slot else 0)
    base = (rng.standard_normal((rows, 5)) * 100).astype(dtype)
    base[rng.random((rows, 5)) < 0.05] = -0.0
    base[rows // 3, 2] = np.nan
    if slot:
        base[-1] = 0
    F0, R0 = base.copy(), np.zeros_like(base)
    rbk._accumulate_numpy(ref_lv, F0, clamp=clamp,
                          R_out=R0 if want_r else None)
    whole = torch.from_numpy(base.copy())
    Rw = torch.zeros_like(whole) if want_r else None
    level_step(lv, whole, clamp=clamp, R_out=Rw)
    plan = lv.level_plan(3)
    assert plan[:, 2].any() and not plan[:, 2].all()
    by_rows = torch.from_numpy(base.copy())
    Rr = torch.zeros_like(by_rows) if want_r else None
    for l0, l1, _, _ in plan.tolist():
        level_step_plain(lv, by_rows, clamp=clamp, R_out=Rr, levels=(l0, l1))
    for got in (whole, by_rows):
        assert np.array_equal(_bits(F0), _bits(got.numpy()))
    if want_r:
        for got in (Rw, Rr):
            assert np.array_equal(_bits(R0), _bits(got.numpy()))


@pytest.mark.parametrize("kind", KINDS)
def test_plain_level_range_splits_anywhere(kind):
    """Any split of the levels into consecutive ranges gives the whole
    pass (the plan's rows are one such split)."""
    lv = port_csr(_lv(kind, 4))
    slot = lv.qpred is not None
    rng = np.random.default_rng(4)
    base = rng.integers(1, 400, size=(lv.n + int(slot), 3)) / 4.0
    if slot:
        base[-1] = 0
    want = torch.from_numpy(base.copy())
    level_step_plain(lv, want)
    cuts = sorted(set(rng.integers(1, lv.n_levels, size=4).tolist()) |
                  {1, lv.n_levels})
    got = torch.from_numpy(base.copy())
    for a, b in zip(cuts[:-1], cuts[1:]):
        level_step_plain(lv, got, levels=(a, b))
    assert torch.equal(want, got)


@pytest.mark.parametrize("kind", KINDS)
def test_device_arrays_carry_the_kernels_gathers(kind):
    """The level pointers, and each run's first source and queue
    predecessor and each queue-only vertex's queue predecessor, which the
    kernels read directly."""
    lv = port_csr(_lv(kind, 0))
    dv = lv.device_arrays("cpu")

    def same(t, a):
        return t.dtype == torch.int32 and np.array_equal(t.numpy(), a)
    assert same(dv.run_ptr, lv.run_ptr)
    assert same(dv.run_src0, lv.esrc[lv.run_starts])
    if lv.qpred is None:
        assert dv.run_qp is None and dv.qonly_qp is None
    else:
        assert same(dv.run_qp, lv.qpred[lv.run_dst])
        if lv.qonly_dst is not None:
            assert same(dv.qonly_ptr, lv.qonly_ptr)
            assert same(dv.qonly_qp, lv.qpred[lv.qonly_dst])


def test_levels_counter_starts_at_zero_and_resets():
    level_step.levels = 7
    level_step.reset_counts()
    assert (level_step.levels, level_step.launches, level_step.calls) == \
        (0, 0, 0)
