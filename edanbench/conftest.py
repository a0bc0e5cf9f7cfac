"""Test set-up for the benchmark's CPU tests: the program's package and
the checkout root on the path, the ``gpu`` marker, and a small copy of the
benchmark (every cell at a test's size) to run cells in."""
import json
import os
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: each configuration cut to a size a test can run in a second
SMALL = {"polybench15-n20": {"N": 4, "kernels": ["atax", "gemm", "lu"]},
         "hpcg-16x6": {"n": 3, "iters": 1}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def small_root(tmp_path):
    """A checkout of the benchmark alone, every configuration at ``SMALL``'s
    size: the harness finds cells, configurations, traffic and metrics in
    it by name."""
    shutil.copytree(ROOT / "edanbench", tmp_path / "edanbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for c in spec["configs"]:
        path = tmp_path / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(SMALL[c["name"]])
        path.write_text(json.dumps(cfg))
    return tmp_path


@pytest.fixture
def cpu_env():
    """Restores the ``EDAN_*`` environment a harness run rewrites."""
    saved = {k: v for k, v in os.environ.items()
             if k.startswith(("EDAN_", "TORCH_EXTENSIONS_DIR",
                              "TRITON_CACHE_DIR"))}
    yield
    for k in [k for k in os.environ
              if k.startswith(("EDAN_", "TORCH_EXTENSIONS_DIR",
                               "TRITON_CACHE_DIR"))]:
        del os.environ[k]
    os.environ.update(saved)
