"""Serving front ends of the port: the sketch search service, and the LM
engine with its prefill/decode steps."""
from .engine import Request, ServeEngine
from .sketch_service import ServiceStats, SketchSearchService
from .step import greedy_sample, make_decode_step, make_prefill_step

__all__ = ["Request", "ServeEngine", "ServiceStats", "SketchSearchService",
           "greedy_sample", "make_decode_step", "make_prefill_step"]
