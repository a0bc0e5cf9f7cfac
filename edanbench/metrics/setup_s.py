"""The run's whole set-up, from the start of run.py to the end of the warm
step, in s.
"""
from __future__ import annotations


def read(run):
    return run.setup_s
