"""K1's work counts on a hand-built plan, and the roofline share they
give."""
import pytest

from edanbench import work
from edanbench.readers import k1_roofline_pct
from types import SimpleNamespace

H100 = "NVIDIA H100 80GB HBM3"


def test_block_counts_by_hand():
    # 10 rows, 12 edges, 6 memory vertices; m = 2, 3 ALU slots: queue
    # edges 6 - 2 = 4 (memory) and 4 - 3 = 1 (ALU); 5 points
    ops, nbytes = work.block(10, 12, 6, 2, 3, 5)
    assert ops == 5 * (12 + 5 + 10)
    assert nbytes == 4 * (12 + 5 + 10) + 16 * 10 * 5
    # unbounded ALUs chain nothing
    assert work.block(10, 12, 6, 2, 0, 1)[0] == 12 + 4 + 10


def test_step_work_sums_blocks():
    traces = [(10, 12, 6), (4, 3, 1)]
    pairs = [(2, 0), (4, 8)]
    ops, nbytes = work.step_work(traces, pairs, 3)
    want = [work.block(*t, m, c, 3) for t in traces for m, c in pairs]
    assert ops == sum(o for o, _ in want)
    assert nbytes == sum(b for _, b in want)


def test_roofline_share_is_100_at_the_bound():
    wps = work.step_work([(1_000_000, 2_000_000, 500_000)], [(4, 8)], 11)
    bound = work.roofline_s(*wps, H100)
    assert bound == pytest.approx(wps[1] / 3.35e12)     # bytes bound it
    run = SimpleNamespace(
        work_per_step=wps, device_name=H100,
        seg={"busy_s": 1.0, "win": {"steps": 2},
             "by_name": {"void (anonymous namespace)::segment_kernel<float>":
                         bound, "level_kernel<double>": bound,
                         "other": 5.0}})
    assert k1_roofline_pct(run) == pytest.approx(100.0)
    run.seg["by_name"]["level_kernel<double>"] *= 2
    assert k1_roofline_pct(run) < 100.0
    assert work.roofline_s(1.0, 1.0, "some other card") is None
