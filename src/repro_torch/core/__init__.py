"""Host-side numpy pieces of the port (copies of the JAX package's
``repro.core``): types, hashing, KMV sampling, and the host sketchers the
families name as their oracles -- ICWS, DMH, the u32 CountSketch and JL,
threshold and priority sampling -- with the paper's WeightedMinHash of
``backend="host"``."""
from .dmh import DMH
from .icws import ICWS, ICWSSketch, StackedICWS, stack_icws
from .kmv import KMV, KMVSketch
from .linear import CountSketchU32, JLU32
from .sampling import PrioritySamplingU32, ThresholdSamplingU32
from .types import SparseVec
from .wmh import StackedWMH, WeightedMinHash, WMHSketch, stack_wmh

__all__ = ["CountSketchU32", "DMH", "ICWS", "ICWSSketch", "JLU32", "KMV",
           "KMVSketch", "PrioritySamplingU32", "SparseVec", "StackedICWS",
           "StackedWMH", "ThresholdSamplingU32", "WMHSketch",
           "WeightedMinHash", "stack_icws", "stack_wmh"]
