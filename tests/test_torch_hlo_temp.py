"""XLA's temp bytes replayed from a scheduled module's text
(``repro_torch.core.hlo.hlo_temp_bytes``) and the dry-run that reports
them (``launch.dryrun.run_cell``).

* On the eight computed cells of ``configs/dryrun_expected.json`` (the
  reference's ``run_cell`` and its compiled, scheduled text), the pass is
  within 0.8-1.25 of XLA's ``temp_size_in_bytes``, each cell's ratio
  printed in its assertion; ``run_cell`` reports it with ``temp_source``
  "hlo", and its ``hbm_per_device_bytes`` (within the same bound),
  ``cpu_bf16_shadow_bytes`` and ``fits_hbm`` are the reference's.
* Small hand-written modules whose temp follows from the rules: a buffer
  handed to a same-shaped elementwise result, a while body's temporaries
  live only at the loop, a temporary moved into a donated parameter's
  allocation between the parameter's last read and the output's write.
* A cell without a recorded text keeps the per-device step's estimate
  (``temp_source`` "step"), which is also reported beside the text's as
  ``temp_size_in_bytes_step``.
"""
import gzip
import json
from pathlib import Path

import pytest

from repro_torch.core.hlo import hlo_temp_bytes
from repro_torch.launch import dryrun as D

CONFIGS = Path(D.__file__).resolve().parents[1] / "configs"
EXPECTED = json.loads((CONFIGS / "dryrun_expected.json").read_text())
COMPUTED = sorted(n for n, e in EXPECTED["cells"].items()
                  if "skipped" not in e["artifact"])
BOUND = (0.8, 1.25)


@pytest.fixture(autouse=True)
def _on_the_host(monkeypatch):
    monkeypatch.setenv("EDAN_TORCH_BACKEND", "cpu")
    monkeypatch.setenv("EDAN_SCHEDULE_CACHE", "off")


def test_eight_computed_cells():
    assert len(COMPUTED) == 8


@pytest.mark.parametrize("name", COMPUTED)
def test_temp_from_the_text_is_xlas(name):
    text = gzip.decompress((D.FIXTURES / f"{name}.hlo.gz")
                           .read_bytes()).decode()
    want = EXPECTED["cells"][name]["artifact"]["memory_analysis"][
        "temp_size_in_bytes"]
    got = hlo_temp_bytes(text)
    ratio = got / want
    assert BOUND[0] <= ratio <= BOUND[1], \
        f"{name}: {got} / XLA's {want} = {ratio:.4f}"


@pytest.mark.parametrize("name", COMPUTED)
def test_run_cell_reports_the_texts_temp_and_the_references_fit(name):
    e = EXPECTED["cells"][name]
    want = e["artifact"]
    got = D.run_cell(e["arch"], e["shape"], e["mesh"], step=False)
    mem = got["memory_analysis"]
    assert mem["temp_source"] == "hlo"
    assert mem["temp_size_in_bytes_step"] is None
    ratio = mem["temp_size_in_bytes"] / \
        want["memory_analysis"]["temp_size_in_bytes"]
    assert BOUND[0] <= ratio <= BOUND[1], f"{name}: temp ratio {ratio:.4f}"
    hbm = got["hbm_per_device_bytes"] / want["hbm_per_device_bytes"]
    assert BOUND[0] <= hbm <= BOUND[1], f"{name}: hbm ratio {hbm:.4f}"
    assert got["cpu_bf16_shadow_bytes"] == want["cpu_bf16_shadow_bytes"]
    assert got["fits_hbm"] == want["fits_hbm"]
    assert got["hbm_per_device_bytes_cpu_backend"] == \
        got["hbm_per_device_bytes"] + got["cpu_bf16_shadow_bytes"]


def test_a_cell_without_text_keeps_the_step_estimate():
    res = D.run_cell("rwkv6-7b", "long_500k", "pod", bf16_params=True)
    mem = res["memory_analysis"]
    assert mem["temp_source"] == "step"
    assert mem["temp_size_in_bytes"] == mem["temp_size_in_bytes_step"] > 0
    assert res["cpu_bf16_shadow_bytes"] == 0


# ------------------------------------------------------------ the rules

HEADER = ("HloModule m, is_scheduled=true{alias}, entry_computation_layout="
          "{{(f32[256]{{0}}, f32[256]{{0}})->f32[256]{{0}}}}\n\n")


def _module(body: str, alias: str = "") -> str:
    return HEADER.format(alias=alias) + body


def test_an_elementwise_result_takes_over_its_dying_operand():
    chain = _module("""ENTRY %main (p0: f32[256], p1: f32[256]) -> f32[256] {
  %p0 = f32[256]{0} parameter(0)
  %p1 = f32[256]{0} parameter(1)
  %a = f32[256]{0} exponential(%p0)
  %b = f32[256]{0} negate(%a)
  ROOT %r = f32[256]{0} sqrt(%b)
}
""")
    both = chain.replace("ROOT %r = f32[256]{0} sqrt(%b)",
                         "ROOT %r = f32[256]{0} add(%a, %b)")
    assert hlo_temp_bytes(chain) == 1024          # a, then b in its place
    assert hlo_temp_bytes(both) == 2048           # a still read with b


def test_a_while_bodys_temporaries_count_at_the_loop():
    text = _module("""%body (bp: (s32[], f32[256])) -> (s32[], f32[256]) {
  %bp = (s32[], f32[256]{0}) parameter(0)
  %i = s32[] get-tuple-element(%bp), index=0
  %one = s32[] constant(1)
  %i2 = s32[] add(%i, %one)
  %v = f32[256]{0} get-tuple-element(%bp), index=1
  %big = f32[1024]{0} concatenate(%v, %v, %v, %v), dimensions={0}
  %s = f32[256]{0} slice(%big), slice={[0:256]}
  %v2 = f32[256]{0} add(%s, %v)
  ROOT %out = (s32[], f32[256]{0}) tuple(%i2, %v2)
}

%cond (cp: (s32[], f32[256])) -> pred[] {
  %cp = (s32[], f32[256]{0}) parameter(0)
  %ci = s32[] get-tuple-element(%cp), index=0
  %n = s32[] constant(4)
  ROOT %lt = pred[] compare(%ci, %n), direction=LT
}

ENTRY %main (p0: f32[256], p1: f32[256]) -> f32[256] {
  %p0 = f32[256]{0} parameter(0)
  %p1 = f32[256]{0} parameter(1)
  %zero = s32[] constant(0)
  %z = s32[] copy(%zero)
  %c = f32[256]{0} copy(%p0)
  %init = (s32[], f32[256]{0}) tuple(%z, %c)
  %w = (s32[], f32[256]{0}) while(%init), condition=%cond, body=%body
  %r = f32[256]{0} get-tuple-element(%w), index=1
  ROOT %o = f32[256]{0} negate(%r)
}
""")
    # the carry (4 + 1024) with the body's concatenate (4096); the slice it
    # feeds (1024) is dead before the output is written, so it moves into
    # the output's allocation
    assert hlo_temp_bytes(text) == 4 + 1024 + 4096
    # a body that keeps the concatenate: its bytes count at the loop
    kept = text.replace("%v2 = f32[256]{0} add(%s, %v)",
                        "%v2 = f32[256]{0} slice(%big), slice={[256:512]}")
    assert hlo_temp_bytes(kept) == 4 + 1024 + 4096


def test_a_temporary_moves_into_a_donated_parameter():
    body = """ENTRY %main (p0: f32[256], p1: f32[256]) -> f32[256] {
  %p0 = f32[256]{0} parameter(0)
  %p1 = f32[256]{0} parameter(1)
  %n0 = f32[256]{0} negate(%p0)
  %t = f32[256]{0} exponential(%p1)
  %u = f32[256]{0} add(%n0, %t)
  ROOT %o = f32[256]{0} sqrt(%u)
}
"""
    donated = _module(body, ", input_output_alias={ {}: (0, {}, may-alias) }")
    # t lives between p0's last read and o's write: p0's allocation holds
    # it; n0 and u (in n0's place) stay temp
    assert hlo_temp_bytes(donated) == 1024
    assert hlo_temp_bytes(_module(body)) == 2048


def test_called_computations_count_where_they_run():
    """A ``call``'s callee and a ``conditional``'s branches run at their
    instruction: their temporaries (a 4096-byte concatenate) count there,
    beside the operand they read; their results are the caller's."""
    call = _module("""%f (a: f32[256]) -> f32[256] {
  %a = f32[256]{0} parameter(0)
  %big = f32[1024]{0} concatenate(%a, %a, %a, %a), dimensions={0}
  ROOT %s = f32[256]{0} slice(%big), slice={[0:256]}
}

ENTRY %main (p0: f32[256], p1: f32[256]) -> f32[256] {
  %p0 = f32[256]{0} parameter(0)
  %p1 = f32[256]{0} parameter(1)
  %e = f32[256]{0} exponential(%p0)
  %c = f32[256]{0} call(%e), to_apply=%f
  ROOT %o = f32[16]{0} slice(%c), slice={[0:16]}
}
""")
    # e (1024) is read by the callee while big (4096) and s (1024) live;
    # the output (64 bytes) holds none of them
    assert hlo_temp_bytes(call) == 1024 + 4096 + 1024
    cond = _module("""%b0 (a: f32[256]) -> f32[256] {
  %a = f32[256]{0} parameter(0)
  %big = f32[1024]{0} concatenate(%a, %a, %a, %a), dimensions={0}
  ROOT %s = f32[256]{0} slice(%big), slice={[0:256]}
}

%b1 (b: f32[256]) -> f32[256] {
  %b = f32[256]{0} parameter(0)
  ROOT %n = f32[256]{0} negate(%b)
}

ENTRY %main (p0: f32[256], p1: f32[256]) -> f32[256] {
  %p0 = f32[256]{0} parameter(0)
  %p1 = f32[256]{0} parameter(1)
  %e = f32[256]{0} exponential(%p0)
  %k = s32[] constant(0)
  %i = s32[] copy(%k)
  %c = f32[256]{0} conditional(%i, %e, %e), branch_computations={%b0, %b1}
  ROOT %o = f32[16]{0} slice(%c), slice={[0:16]}
}
""")
    # the 4-byte branch index, dead before the output is written, moves
    # into the output's allocation
    assert hlo_temp_bytes(cond) == 1024 + 4096 + 1024
