"""The port stands alone: nothing under ``src/repro_torch`` and nothing in
``chip_smoke.py`` imports JAX, the JAX package (``repro``) or
``ml_dtypes`` (which the card's machine need not have)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_port_has_files():
    names = {p.name for p in FILES}
    assert {"backend.py", "level_step.py", "paper.py", "wkv6.py", "ssd.py",
            "rwkv6.py", "zamba2.py", "engine.py", "serve.py",
            "flash_attention.py", "transformer.py", "moe.py",
            "schedule_cache.py", "trace_store.py", "analysis.py",
            "faults.py", "hlo.py", "fxgraph.py", "encdec.py", "tracing.py",
            "optimizer.py", "train_loop.py", "checkpoint.py", "fault.py",
            "compression.py", "pipeline.py", "rules.py", "mesh.py",
            "train.py", "dryrun.py", "remat.py", "chip_smoke.py",
            "reference.py", "collectives.py", "moe_parallel.py",
            "quickstart.py", "latency_sensitivity.py", "serve_lm.py",
            "train_lm.py", "parallel.py", "sharded.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(BANNED)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_the_check_sees_a_banned_import(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("def f():\n    from repro.core import EDag\n"
                 "    import jax.numpy as jnp\n    import ml_dtypes\n")
    assert _imported_roots(f) >= {"repro", "jax", "ml_dtypes"}
