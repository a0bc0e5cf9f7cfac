"""The roofline time of the traced steps' work (edanbench/work.py) over
K1's device time, %.
"""
from edanbench.readers import k1_roofline_pct as read  # noqa: F401
