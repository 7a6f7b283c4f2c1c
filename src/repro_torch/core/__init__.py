"""Host-side numpy pieces the serving path needs (copies of the JAX
package's ``repro.core`` types, hashing and KMV sampling)."""
from .kmv import KMV, KMVSketch
from .types import SparseVec

__all__ = ["KMV", "KMVSketch", "SparseVec"]
