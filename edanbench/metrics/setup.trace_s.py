"""Host seconds of building the configuration's traces (tracing and
finalize) in set-up.
"""
from __future__ import annotations


def read(run):
    return run.setup_trace_s
