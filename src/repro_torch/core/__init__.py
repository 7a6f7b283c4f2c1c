"""Host-side numpy pieces of the port (copies of the JAX package's
``repro.core`` types, hashing, KMV sampling and the host ICWS sketch)."""
from .icws import ICWS, ICWSSketch, StackedICWS, stack_icws
from .kmv import KMV, KMVSketch
from .types import SparseVec

__all__ = ["ICWS", "ICWSSketch", "KMV", "KMVSketch", "SparseVec",
           "StackedICWS", "stack_icws"]
