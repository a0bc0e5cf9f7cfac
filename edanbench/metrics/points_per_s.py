"""Sweep points completed over the window's time on the host's clock,
points/s.
"""
from edanbench.readers import points_per_s as read  # noqa: F401
