"""Write the reference package's dry-run of a few cells for the PyTorch
port's dry-run (``repro_torch.launch.dryrun``) to be held to.

Each cell (``CELLS``: arch x shape x mesh) runs the JAX package's own
``repro.launch.dryrun.run_cell`` in a child process of its own, which
imports that module first so that it fakes its 512 host devices itself.
The child records the compiled module's text (the string
``jax.stages.Compiled.as_text`` returns, caught around the method; nothing
of the JAX package is changed) and ``run_cell``'s artifact.

Writes, under ``src/repro_torch/configs/``:

* ``hlo/dryrun/<arch>__<shape>__<mesh>.hlo.gz``: each compiled cell's
  text, gzipped (level 9, mtime 0);
* ``dryrun_expected.json``: per cell the artifact without its seconds
  (``t_lower_s``, ``t_compile_s``), with the text's byte count and the
  mesh's axes; a ``skipped`` record where the reference skips the cell.

Deterministic: two runs write the same bytes.  About 1-2 minutes on the
CPU, one cell at a time.

Usage: PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dryrun_expected.py
"""
from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "src" / "repro_torch" / "configs"
OUT = CONFIGS / "dryrun_expected.json"
HLO_DIR = CONFIGS / "hlo" / "dryrun"

#: (arch, shape, mesh) and what each covers.
CELLS = [
    ("qwen3-0.6b", "train_4k", "pod"),             # the model the port trains
    ("qwen3-0.6b", "prefill_32k", "pod"),          # the model the port serves
    ("qwen3-0.6b", "decode_32k", "pod"),
    ("qwen3-0.6b", "train_4k", "multipod"),        # the pod axis
    ("qwen3-0.6b", "long_500k", "pod"),            # a skipped record
    ("mixtral-8x7b", "train_4k", "pod"),           # MoE
    ("zamba2-7b", "train_4k", "pod"),              # hybrid
    ("rwkv6-7b", "long_500k", "pod"),              # recurrent at 500k
    ("seamless-m4t-large-v2", "decode_32k", "pod"),  # encoder-decoder cache
]
SECONDS = ("t_lower_s", "t_compile_s")

_CHILD = r"""
import json, os, sys
import repro.launch.dryrun as dr        # sets XLA_FLAGS before jax loads
import jax

texts = []
_as_text = jax.stages.Compiled.as_text


def as_text(self, *a, **kw):
    t = _as_text(self, *a, **kw)
    texts.append(t)
    return t


jax.stages.Compiled.as_text = as_text
arch, shape, mesh, out = sys.argv[1:5]
res = dr.run_cell(arch, shape, mesh, out)
with open(os.path.join(out, "cell.json"), "w") as f:
    json.dump(res, f, default=str)
if texts:
    assert len(set(texts)) == 1, "one compiled module per cell"
    with open(os.path.join(out, "cell.hlo"), "w") as f:
        f.write(texts[0])
print("OK")
"""


def cell_name(arch: str, shape: str, mesh: str) -> str:
    return f"{arch}__{shape}__{mesh}"


def run_reference_cell(arch: str, shape: str, mesh: str) -> tuple:
    """(artifact, compiled text or None) of one cell, in a child
    process."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        res = subprocess.run([sys.executable, "-c", _CHILD, arch, shape,
                              mesh, tmp], env=env, capture_output=True,
                             text=True, timeout=1800)
        if res.returncode != 0 or "OK" not in res.stdout:
            raise SystemExit(f"{arch} {shape} {mesh}:\n" +
                             res.stdout[-2000:] + res.stderr[-3000:])
        art = json.loads((Path(tmp) / "cell.json").read_text())
        hlo = Path(tmp) / "cell.hlo"
        return art, (hlo.read_text() if hlo.exists() else None)


def main() -> None:
    HLO_DIR.mkdir(parents=True, exist_ok=True)
    cells = {}
    gz_total = 0
    for arch, shape, mesh in CELLS:
        name = cell_name(arch, shape, mesh)
        art, text = run_reference_cell(arch, shape, mesh)
        for k in SECONDS:
            art.pop(k, None)
        entry = {"arch": arch, "shape": shape, "mesh": mesh,
                 "artifact": art}
        if text is not None:
            data = gzip.compress(text.encode(), compresslevel=9, mtime=0)
            (HLO_DIR / f"{name}.hlo.gz").write_bytes(data)
            entry["text_bytes"] = len(text.encode())
            entry["gz_bytes"] = len(data)
            gz_total += len(data)
        cells[name] = entry
        print(f"{name}: {'skipped' if text is None else len(text)} "
              f"({entry.get('gz_bytes', 0)} B gzipped)", flush=True)
    OUT.write_text(json.dumps({"cells": cells, "gz_total_bytes": gz_total},
                              indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT.relative_to(ROOT)}; fixtures {gz_total} B gzipped")


if __name__ == "__main__":
    main()
