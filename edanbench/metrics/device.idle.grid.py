"""Share of the traced steps in which no device operation ran, %.
"""
from edanbench.readers import device_idle_pct as read  # noqa: F401
