"""The training data pipeline of the port (``pipeline.py``)."""
from .pipeline import DataState, SyntheticLMData

__all__ = ["SyntheticLMData", "DataState"]
