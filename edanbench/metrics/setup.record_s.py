"""Host seconds the scheduler spent recording schedules in set-up
(scheduler.stats record_seconds).
"""
from __future__ import annotations


def read(run):
    return run.setup_record_s
