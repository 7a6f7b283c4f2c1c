"""PyTorch/CUDA port of the §1.3 dataset-search serving path.

A second package beside the JAX reference (``src/repro``): it imports
``torch``, ``numpy`` and the standard library only -- never ``jax`` and
nothing of ``repro``.  It carries ``SketchSearchService(family=...,
backend="device")`` on one device for all six families of the JAX package
(ICWS, DMH, CountSketch, JL, threshold and priority sampling), with
hand-written CUDA kernels for each family's sketch (the sampling rows are
built on the host) and fused multi-field estimate
(``repro_torch.kernels``), and the paper's library surface
``SketchCorpus`` (one ICWS field: pairwise, one-vs-many and many-vs-many
estimates).  Entry points run on the card unless the caller passes
``device="cpu"``.  Beside the search path: sketch-based gradient
compression (``repro_torch.optim.compression``, the dense CountSketch
kernel) and flash attention (``repro_torch.kernels.flash_attention``,
with its oracle ``repro_torch.models.attention.chunked_attention``); they
run where their tensors lie.
"""
from .data.corpus import SketchCorpus
from .data.dataset_search import DatasetSearchIndex, SearchResult
from .serve.sketch_service import SketchSearchService

__all__ = ["DatasetSearchIndex", "SearchResult", "SketchCorpus",
           "SketchSearchService"]
