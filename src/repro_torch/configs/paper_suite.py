"""The paper's own workload configs (PolyBench / HPCG / LULESH analysis
settings used by the benchmarks; §4-5 of the paper)."""
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class AnalysisConfig:
    m: int = 4                      # memory issue slots (paper §4.1)
    alpha0: float = 50.0            # baseline DRAM latency, cycles/ns
    alpha_mem: float = 200.0        # Fig 9 / Table 1 memory access cost
    alpha_sweep: Tuple[float, ...] = tuple(range(50, 301, 25))
    alpha_sweep_full: Tuple[float, ...] = tuple(range(50, 301, 5))
    cache_line: int = 64
    cache_ways: int = 2
    cache_sizes: Tuple[int, ...] = (0, 32 * 1024, 64 * 1024)
    tau: float = 100.0              # data-movement phase width (Fig 15/16)


POLYBENCH_N = 20                    # trace size for the ranking study
SIM_COMPUTE_SLOTS = 8               # ground-truth realism: finite ALU issue width
HPCG_N = 16                         # the paper's data size (16^3)
HPCG_ITERS = 6                      # paper used 50; 6 keeps the trace ~1M vertices
LULESH_NE = 10                      # ~1000 elements (paper's data size 1000)
LULESH_ITERS = 3

ANALYSIS = AnalysisConfig()
