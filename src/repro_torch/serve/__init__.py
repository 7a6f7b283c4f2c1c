"""Serving front end of the port."""
from .sketch_service import ServiceStats, SketchSearchService

__all__ = ["ServiceStats", "SketchSearchService"]
