"""Write the reference package's frontend results for the PyTorch port.

Runs the JAX package on the CPU, and the port's PyTorch-graph frontend on
the CPU where the reference must analyse the port's own eDAGs:

* HLO fixtures, written gzipped under ``src/repro_torch/configs/hlo/``:
  - ``synth``: ``tests/test_hlo.py``'s ``SYNTH`` module (read from the
    test's source);
  - ``scan``: the single-device module ``tests/test_hlo.py::
    test_real_compiled_module_roundtrip`` compiles (a 5-step scan of
    ``tanh(c @ b)`` over 32 x 32);
  - ``train`` and ``decode``: the sharded train and decode steps that
    ``tests/test_dryrun_small.py``'s script compiles on a (2, 4)
    ("data", "model") mesh of 8 forced host devices (its own script, run
    in a child process that then writes the two modules' text).
  For each: ``analyze_collectives``, ``hlo_flops_estimate``,
  ``hlo_hbm_bytes_estimate`` and ``collective_sensitivity`` at m = 4.
* Twins at the paper's sizes (PolyBench N=20, HPCG CG n=16 x 6
  iterations, LULESH ne=10 x 3 steps), traced with float32 inputs (the
  reference's default dtype):
  - each reference twin's jaxpr eDAG: vertices, edges, labels, digest and
    the cost and byte sums;
  - each port twin's eDAG from ``repro_torch.core.fxgraph`` (the same
    summary), and the JAX package's ``report`` and ``sweep_grid`` (alphas
    ``linspace(50, 300, 13)``, m (2, 4, 8), ALU slots (0, 8)) on the same
    arrays through ``EDag.from_arrays``.

Writes ``src/repro_torch/configs/frontend_expected.json``.  Deterministic:
two runs write the same bytes.

Usage: PYTHONPATH=src JAX_PLATFORMS=cpu python tools/frontend_expected.py
"""
from __future__ import annotations

import ast
import gzip
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from service_expected import plain

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "src" / "repro_torch" / "configs"
OUT = CONFIGS / "frontend_expected.json"
HLO_DIR = CONFIGS / "hlo"

MESH_2x4 = [["data", 2], ["model", 4]]
FIXTURES = {"synth": MESH_2x4, "scan": [["data", 1]],
            "train": MESH_2x4, "decode": MESH_2x4}
TWINS = dict(polybench_N=20, hpcg_n=16, hpcg_iters=6, lulesh_ne=10,
             lulesh_iters=3, seed=0)
GRID = dict(alphas=np.linspace(50.0, 300.0, 13).tolist(), ms=[2, 4, 8],
            compute_slots=[0, 8])
SENS_M = 4

_DUMP = r"""
open(os.environ["EDAN_HLO_TRAIN"], "w").write(txt)
open(os.environ["EDAN_HLO_DECODE"], "w").write(dcompiled.as_text())
"""


def source_constant(path: Path, name: str) -> str:
    """A module-level string constant of a test file, read from source."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(f"{name} not in {path}")


def scan_module() -> str:
    import jax
    import jax.numpy as jnp

    def f(a, b):
        def body(c, _):
            return jnp.tanh(c @ b), None
        out, _ = jax.lax.scan(body, a, None, length=5)
        return out.sum()
    a = jnp.ones((32, 32))
    b = jnp.ones((32, 32))
    return jax.jit(f).lower(a, b).compile().as_text()


def dryrun_modules() -> tuple:
    """The train and decode modules of ``test_dryrun_small.py``'s script,
    compiled in a child process on 8 forced host devices."""
    script = source_constant(ROOT / "tests" / "test_dryrun_small.py",
                             "_SCRIPT")
    with tempfile.TemporaryDirectory() as tmp:
        train, decode = Path(tmp) / "train.hlo", Path(tmp) / "decode.hlo"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu", EDAN_HLO_TRAIN=str(train),
                   EDAN_HLO_DECODE=str(decode))
        res = subprocess.run([sys.executable, "-c", script + _DUMP],
                             env=env, capture_output=True, text=True,
                             timeout=1800)
        if res.returncode != 0 or "OK" not in res.stdout:
            raise SystemExit(res.stdout[-2000:] + res.stderr[-3000:])
        return train.read_text(), decode.read_text()


def write_fixture(name: str, text: str) -> int:
    HLO_DIR.mkdir(parents=True, exist_ok=True)
    data = gzip.compress(text.encode(), compresslevel=9, mtime=0)
    (HLO_DIR / f"{name}.hlo.gz").write_bytes(data)
    return len(data)


def hlo_entry(text: str, axes) -> dict:
    from repro.core.hlo import (analyze_collectives, hlo_flops_estimate,
                                hlo_hbm_bytes_estimate)
    from repro.core.sensitivity import collective_sensitivity
    axes = [tuple(a) for a in axes]
    sens = collective_sensitivity(text, axes, m=SENS_M)
    return dict(
        mesh_axes=[list(a) for a in axes],
        analyze_collectives=analyze_collectives(text, axes),
        flops=hlo_flops_estimate(text),
        hbm_bytes=hlo_hbm_bytes_estimate(text),
        collective_sensitivity=dict(
            per_axis={k: v.row() for k, v in sens["per_axis"].items()},
            raw=sens["raw"]))


# The twins whose eDAG must equal the reference's: their decompositions
# agree between the frameworks.
MUST_AGREE = ("2mm", "3mm", "atax", "bicg", "mvt", "gemm", "gesummv",
              "syrk", "syr2k")


def agreeing(expected: dict) -> list:
    """The twins whose recorded port eDAG summary equals the reference's."""
    port = expected["port_twins"]
    return [name for name, ref in expected["reference_twins"].items()
            if all(port[name][k] == v for k, v in ref.items())]


def summary(g) -> dict:
    g.trace_digest()
    return dict(vertices=int(g.n_vertices), edges=int(g.n_edges),
                labels=list(g.labels()), digest=g.trace_digest(),
                cost_sum=float(g.cost.sum()),
                nbytes_sum=float(g.nbytes.sum()),
                mem_vertices=int(g.is_mem.sum()))


def reference_twins() -> dict:
    """The reference twins' jaxpr eDAGs at the paper's sizes."""
    import jax
    import jax.numpy as jnp
    import repro.core as R
    from repro.apps import hpcg, lulesh, polybench
    from repro_torch.apps import lulesh as tl
    from repro_torch.apps import polybench as tp
    f32 = lambda a: jnp.asarray(a, jnp.float32)   # noqa: E731
    out = {}
    for name, fn in polybench.JAX_KERNELS.items():
        args = tp.twin_inputs(name, TWINS["polybench_N"], TWINS["seed"])
        out[name] = summary(R.edag_from_fn(fn, *map(f32, args)))
    n, iters = TWINS["hpcg_n"], TWINS["hpcg_iters"]
    b = hpcg.build_problem(n, TWINS["seed"])
    out["cg"] = summary(R.edag_from_fn(
        lambda b: hpcg.cg_jax(b, n, iters), f32(b)))
    ne, iters = TWINS["lulesh_ne"], TWINS["lulesh_iters"]
    step = lulesh.make_jax_step(ne)
    out["lulesh"] = summary(R.edag_from_fn(
        lambda *s: jax.lax.scan(step, tuple(s), None, length=iters),
        *map(f32, tl.initial_state(ne, TWINS["seed"]))))
    return out


def port_twin_graphs() -> dict:
    """The port twins' eDAGs from the PyTorch-graph frontend (on ``meta``
    float32 inputs) — the traces ``chip_smoke.py`` phase "frontend"
    repeats on the card."""
    import torch
    from repro_torch.apps import hpcg, lulesh, polybench
    from repro_torch.core.fxgraph import edag_from_fn
    meta = lambda a: torch.empty(np.shape(a), dtype=torch.float32,  # noqa
                                 device="meta")
    out = {}
    for name, fn in polybench.TORCH_KERNELS.items():
        args = polybench.twin_inputs(name, TWINS["polybench_N"])
        out[name] = edag_from_fn(fn, *map(meta, args))
    n, iters = TWINS["hpcg_n"], TWINS["hpcg_iters"]
    out["cg"] = edag_from_fn(lambda b: hpcg.cg_torch(b, n, iters),
                             meta(hpcg.build_problem(n)))
    ne, iters = TWINS["lulesh_ne"], TWINS["lulesh_iters"]
    step = lulesh.make_torch_step(ne, "meta")
    out["lulesh"] = edag_from_fn(lambda *s: lulesh.run_steps(step, s, iters),
                                 *map(meta, lulesh.initial_state(ne)))
    return out


def analyses(g) -> dict:
    """The JAX package's report and sweep grid on the port's eDAG."""
    import repro.core as R
    g.trace_digest()
    rg = R.EDag.from_arrays(g.cost, g.is_mem, g.nbytes, g.src, g.dst,
                            labels=list(g.labels()))
    rep = R.report(rg)
    grid = R.sweep_grid(rg, GRID["alphas"], ms=GRID["ms"],
                        compute_slots=GRID["compute_slots"])
    return dict(report=plain(vars(rep)), sweep_grid=plain(grid))


def main() -> None:
    os.environ.setdefault("EDAN_TORCH_BACKEND", "cpu")
    os.environ["EDAN_SCHEDULE_CACHE"] = "off"
    texts = dict(synth=source_constant(ROOT / "tests" / "test_hlo.py",
                                       "SYNTH"),
                 scan=scan_module())
    texts["train"], texts["decode"] = dryrun_modules()
    hlo = {}
    for name, text in texts.items():
        size = write_fixture(name, text)
        hlo[name] = dict(hlo_entry(text, FIXTURES[name]),
                         text_bytes=len(text.encode()), gz_bytes=size)
        print(f"{name}: {len(text.encode())} bytes, {size} gzipped",
              flush=True)
    ref = reference_twins()
    port = {}
    for name, g in port_twin_graphs().items():
        port[name] = dict(summary(g), **analyses(g))
        print(f"twin {name}: reference {ref[name]['vertices']} vertices, "
              f"port {port[name]['vertices']}", flush=True)
    doc = dict(config=dict(fixtures=FIXTURES, twins=TWINS, grid=GRID,
                           sens_m=SENS_M),
               hlo=plain(hlo), reference_twins=ref, port_twins=port)
    OUT.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
