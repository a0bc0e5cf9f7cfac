import importlib.util
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    # The image has no hypothesis; register the deterministic stub in its
    # place so property tests still run (see tests/_hypothesis_stub.py).
    _spec = importlib.util.spec_from_file_location(
        "hypothesis",
        os.path.join(os.path.dirname(__file__), "_hypothesis_stub.py"))
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
    sys.modules["hypothesis"] = _mod
    sys.modules["hypothesis.strategies"] = _mod.strategies

from hypothesis import settings

settings.register_profile("ci", max_examples=30, deadline=None)
settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")
