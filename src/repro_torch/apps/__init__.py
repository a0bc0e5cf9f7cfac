"""The paper's analyzed applications as scalar-traced kernels: PolyBench,
HPCG, LULESH (§4-5)."""
from . import polybench, hpcg, lulesh

__all__ = ["polybench", "hpcg", "lulesh"]
