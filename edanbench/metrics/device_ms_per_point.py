"""The card's busy time per sweep point completed in the window, ms: the
union of the device operations in the profiled window over its points.
"""
from edanbench.readers import device_ms_per_point as read  # noqa: F401
