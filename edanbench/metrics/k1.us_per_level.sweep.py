"""K1's device time per dependent level in the traced steps, us.
"""
from edanbench.readers import k1_us_per_level as read  # noqa: F401
