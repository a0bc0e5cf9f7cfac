"""Serving layer of the port: the model-serving engine (``ServeEngine``,
``Request``)."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
