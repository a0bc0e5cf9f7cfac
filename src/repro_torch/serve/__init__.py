"""Serving layer of the port: the model-serving engine (``ServeEngine``,
``Request``) and the prefill batch of a prompt (``prefill_batch``)."""
from .engine import Request, ServeEngine, prefill_batch

__all__ = ["Request", "ServeEngine", "prefill_batch"]
