"""Schedule recordings inside the window per step: re-recordings of points
whose recorded order did not certify.
"""
from edanbench.readers import records_per_step as read  # noqa: F401
