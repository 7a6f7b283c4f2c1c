"""Host-side numpy pieces of the port (copies of the JAX package's
``repro.core``): types and the exact ground truth, hashing, rounding, the
paper's sketchers -- WeightedMinHash (Algorithms 3-5) and its baselines
MinHash (Algorithms 1-2), KMV, the f64 JL and CountSketch -- the host
oracles of the serving families (ICWS, DMH, the u32 CountSketch and JL,
threshold and priority sampling), and the storage-matched registry
``make``."""
from .types import (SparseVec, fact1_bound, inner, inner_fast,
                    intersection_norms, theorem2_bound)
from .hashing import MERSENNE_P, AffineHashFamily, PairHashFamily
from .rounding import round_counts, round_unit, rounded_values
from .progmin import progression_min, progression_min_bruteforce
from .wmh import (DEFAULT_L, StackedWMH, WeightedMinHash, WMHSketch,
                  compensated_sum, sketch_bruteforce, stack_wmh)
from .minhash import MinHash, MHSketch, stack_mh
from .kmv import KMV, KMVSketch
from .linear import (CountSketch, CountSketchU32, CSSketch, JL, JLSketch,
                     JLU32)
from .sampling import (PrioritySamplingU32, SampleSketch,
                       ThresholdSamplingU32)
from .icws import ICWS, ICWSSketch, StackedICWS, stack_icws
from .dmh import DMH
from .registry import FACTORIES, PAPER_METHODS, make

__all__ = [
    "SparseVec", "inner", "inner_fast", "intersection_norms",
    "theorem2_bound", "fact1_bound",
    "MERSENNE_P", "AffineHashFamily", "PairHashFamily",
    "round_counts", "round_unit", "rounded_values",
    "progression_min", "progression_min_bruteforce",
    "DEFAULT_L", "WeightedMinHash", "WMHSketch", "compensated_sum",
    "sketch_bruteforce", "stack_wmh", "StackedWMH",
    "MinHash", "MHSketch", "stack_mh", "KMV", "KMVSketch",
    "CountSketch", "CountSketchU32", "CSSketch", "JL", "JLSketch", "JLU32",
    "ThresholdSamplingU32", "PrioritySamplingU32", "SampleSketch",
    "ICWS", "ICWSSketch", "StackedICWS", "stack_icws", "DMH",
    "FACTORIES", "PAPER_METHODS", "make",
]
