"""The idle split (``edanbench/idle_split.py``) on a profile of synthetic
events: a gap split across two nested spans, a gap under no span, the
device-side copies of the program's spans left out of the device's busy
time, and the split summing to ``devtrace.reduce``'s idle time."""
from types import SimpleNamespace

import pytest

from edanbench import devtrace, idle_split

#: 1 ms in ns
MS = 1_000_000


class _Event:
    def __init__(self, name, t0, t1, dev=False, user=False):
        self._e = (name, t0 * MS, (t1 - t0) * MS, dev, user)

    def name(self):
        return self._e[0]

    def start_ns(self):
        return self._e[1]

    def duration_ns(self):
        return self._e[2]

    def device_type(self):
        return "DeviceType.CUDA" if self._e[3] else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._e[4]


def fake_profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


#: a 1000-ms window: the grid span over 100-900 with verify (300-500) and
#: the dtype policy (600-700) inside it; the card busy 0-150, 200-350,
#: 450-620 and 950-980; the spans' device-side copies, which the profiler
#: flags as user annotations, cover 300-500 and 600-700
EVENTS = [
    _Event("edanbench.window", 0, 1000, user=True),
    _Event("edanbench.step", 50, 990, user=True),
    _Event("edan.grid", 100, 900, user=True),
    _Event("edan.verify", 300, 500, user=True),
    _Event("edan.backend.accumulate", 600, 700, user=True),
    _Event("cudaLaunchKernel", 610, 611),
    _Event("segment_kernel<float>", 0, 150, dev=True),
    _Event("segment_kernel<double>", 200, 350, dev=True),
    _Event("reduce_kernel", 450, 620, dev=True),
    _Event("Memcpy DtoH", 950, 980, dev=True),
    _Event("edan.verify", 300, 500, dev=True, user=True),
    _Event("edan.backend.accumulate", 600, 700, dev=True, user=True),
    _Event("edanbench.step", 0, 980, dev=True, user=True),
]


def test_idle_is_split_at_span_boundaries():
    got = idle_split.idle_by_span(fake_profile(EVENTS))
    want = {"edan.grid": 50 + 200, "edan.verify": 100,
            "edan.backend.accumulate": 80, "": 50 + 20}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v * 1e-3, abs=1e-12)


def test_the_split_sums_to_the_reduced_idle_time():
    prof = fake_profile(EVENTS)
    red = devtrace.reduce(prof)
    # the spans' device-side copies are not device operations
    assert not any(k.startswith("edan") for k in red["by_name"])
    assert red["busy_s"] == pytest.approx(0.5, abs=1e-12)
    assert red["window_s"] == pytest.approx(1.0, abs=1e-12)
    split = idle_split.idle_by_span(prof)
    assert abs(sum(split.values()) - (red["window_s"] - red["busy_s"])) \
        < 1e-9
    # the longest gap (620-950) is named by the program's span at its middle
    assert red["gaps"][0] == ["edan.grid", pytest.approx(0.33)]


def test_without_program_spans_every_idle_second_is_unspanned():
    prof = fake_profile([e for e in EVENTS
                         if not e.name().startswith("edan.")])
    red = devtrace.reduce(prof)
    split = idle_split.idle_by_span(prof)
    assert split.keys() == {""}
    assert split[""] == pytest.approx(red["window_s"] - red["busy_s"],
                                      abs=1e-12)


def test_spans_past_the_window_are_cut_to_it():
    events = [_Event("edanbench.window", 100, 200, user=True),
              _Event("edan.sched.rerecord", 50, 150, user=True),
              _Event("edan.grid", 40, 300, user=True),
              _Event("segment_kernel<float>", 90, 110, dev=True)]
    split = idle_split.idle_by_span(fake_profile(events))
    assert split == pytest.approx({"edan.sched.rerecord": 40e-3,
                                   "edan.grid": 50e-3}, abs=1e-12)
    counts = idle_split.span_counts(fake_profile(events))
    assert counts == {}          # neither opened inside the window


def test_no_window_no_split():
    prof = fake_profile([e for e in EVENTS
                         if e.name() != devtrace.WINDOW])
    assert idle_split.idle_by_span(prof) is None
    assert devtrace.reduce(prof) is None


@pytest.mark.parametrize("share", sorted(idle_split.SHARES))
def test_a_share_reads_nothing_without_a_split_or_busy_time(share):
    names = idle_split.SHARES[share]
    full = dict(busy_s=0.5, window_s=1.0,
                idle_by_span={n: 0.125 for n in names})
    assert idle_split.idle_share_pct(full, names) == \
        pytest.approx(12.5 * len(names))
    # the CPU cells: no device trace, so no busy time and no split
    assert idle_split.idle_share_pct(None, names) is None
    assert idle_split.idle_share_pct(dict(full, busy_s=None), names) is None
    assert idle_split.idle_share_pct(dict(full, busy_s=0.0), names) is None
    no_split = {k: v for k, v in full.items() if k != "idle_by_span"}
    assert idle_split.idle_share_pct(no_split, names) is None


@pytest.mark.parametrize("cell", ["polybench15-n20.suite", "hpcg-16x6.sweep"])
def test_a_traced_run_on_the_cpu_has_no_split(small_root, cpu_env, cell):
    """The CPU path has no device trace: the run is correct, the split is
    left out, and the harness's reducer is restored afterwards."""
    reduce = devtrace.reduce
    line = idle_split.run(cell, 2 ** 31 + 11, device="cpu", root=small_root)
    assert devtrace.reduce is reduce
    assert line["correct"] and line["steps"] >= 1
    assert line["traced_points_per_s"] > 0
    assert "idle_by_span" not in line
