"""Serving layer of the port: the model-serving engine (``ServeEngine``,
``Request``, ``prefill_batch``) and the fault-tolerant analysis service
(``AnalysisService`` and its deterministic fault-injection layer
``faults``)."""
from .analysis import (AnalysisRequest, AnalysisResult, AnalysisService,
                       default_deadline_s, default_max_retries)
from .engine import Request, ServeEngine, prefill_batch
from . import faults

__all__ = ["Request", "ServeEngine", "prefill_batch", "AnalysisRequest",
           "AnalysisResult", "AnalysisService", "default_deadline_s",
           "default_max_retries", "faults"]
