"""EDAN core: eDAG construction, the level kernel's dispatch, the cost
model, the metrics, the batched §4 simulator, the persistent schedule
cache and trace store, union suites, object sensitivity and the placement
search.

Three trace frontends over one analysis core:
  * scalar   (``trace``)   — the paper's Algorithm 1 over instruction
    streams;
  * PyTorch  (``fxgraph``) — array-level eDAG of a PyTorch program, from
    its functionalized pre-dispatch ATen graph;
  * HLO      (``hlo``)     — a compiled post-SPMD module (collectives are
    the remote memory accesses), behind the per-axis fabric-latency
    analysis.
"""
from .graph import EDag, IndexOverflowError, MemLayering, concat_edags
from .plan import ExecPolicy, SweepSpec, replay_mem_budget
from .cache import NoCache, SetAssociativeCache, make_cache
from .trace import Tracer, Value, build_edag_from_trace
from .cost import (CostModelParams, memory_cost_bounds, total_cost_bounds,
                   layered_upper_bound, non_memory_cost, analyze)
from .metrics import (lambda_abs, lambda_rel, bandwidth_utilization,
                      bandwidth_sweep, cost_vector, cost_matrix,
                      data_movement_over_time, grid_report, report,
                      suite_grid_report, sweep_report, t_inf_sweep, Report)
from .backend import (LevelCSR, column_quanta, level_accumulate, levelize,
                      replay_accumulate, replay_dtype_policy,
                      segment_max_rows, segment_sum_rows, select_backend)
from .scheduler import (simulate, simulate_batch, simulate_reference,
                        simulate_reference_classes, latency_sweep, sweep_grid)
from .placement import (PlacementObject, PlacementReport,
                        objects_from_edag, object_class_map,
                        placement_rows, search_placement)
from .suite import (EDagSuite, suite_latency_sweep, suite_sweep_grid,
                    suite_t_inf_sweep)
from . import schedule_cache
from .trace_store import (save_edag, load_edag, put_trace, get_trace,
                          trace_store_dir)
from .hlo import (parse_hlo, analyze_collectives, shape_bytes,
                  hlo_flops_estimate, hlo_hbm_bytes_estimate,
                  axis_signature_table)
from .fxgraph import edag_from_fn, edag_from_graph
from .sensitivity import (AxisSensitivity, axis_latency_sweep,
                          axis_latency_grid, collective_sensitivity,
                          object_sensitivity, suite_axis_latency_grid)

__all__ = [
    "EDag", "IndexOverflowError", "MemLayering", "ExecPolicy", "SweepSpec",
    "replay_mem_budget", "NoCache", "SetAssociativeCache", "make_cache",
    "save_edag", "load_edag", "put_trace", "get_trace", "trace_store_dir",
    "schedule_cache",
    "Tracer", "Value", "build_edag_from_trace", "CostModelParams",
    "memory_cost_bounds", "total_cost_bounds", "layered_upper_bound",
    "non_memory_cost", "analyze", "lambda_abs", "lambda_rel",
    "bandwidth_utilization", "bandwidth_sweep", "cost_vector", "cost_matrix",
    "data_movement_over_time", "grid_report", "report", "sweep_report",
    "t_inf_sweep", "Report", "LevelCSR", "column_quanta", "level_accumulate",
    "levelize", "replay_accumulate", "replay_dtype_policy", "select_backend",
    "simulate", "simulate_batch", "simulate_reference",
    "simulate_reference_classes", "latency_sweep", "sweep_grid",
    "concat_edags", "suite_grid_report", "segment_max_rows",
    "segment_sum_rows", "EDagSuite", "suite_latency_sweep",
    "suite_sweep_grid", "suite_t_inf_sweep", "PlacementObject",
    "PlacementReport", "objects_from_edag", "object_class_map",
    "placement_rows", "search_placement", "object_sensitivity",
    "AxisSensitivity", "axis_latency_sweep", "axis_latency_grid",
    "suite_axis_latency_grid", "parse_hlo", "analyze_collectives",
    "shape_bytes", "hlo_flops_estimate", "hlo_hbm_bytes_estimate",
    "axis_signature_table", "collective_sensitivity", "edag_from_fn",
    "edag_from_graph",
]
