"""Share of sweep columns the float32 certificate sent to the float64 rerun
in the window, %.
"""
from edanbench.readers import demoted_share_pct as read  # noqa: F401
