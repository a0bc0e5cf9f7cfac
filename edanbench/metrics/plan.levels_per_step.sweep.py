"""Dependent levels K1 ran per step in the window (level_step.levels).
"""
from edanbench.readers import levels_per_step as read  # noqa: F401
