"""The sketchers of the paper's comparison at equal storage (copy of
``repro.core.registry``).

``make(method, storage_doubles, seed)`` builds one method's sketcher, whose
``sketch`` / ``estimate`` follow that method's class, sized so that a
sketch's total storage in 64-bit-double equivalents (the paper's x-axis)
matches ``storage_doubles``:

  jl    : m rows of doubles                        -> m = storage
  cs    : 5 reps x width doubles                   -> width = storage / 5
  mh    : 1.5 per sample (32b hash + 64b value)    -> m = storage / 1.5
  kmv   : 1.5 per sample                           -> k = storage / 1.5
  wmh   : 1.5 per sample + 1 (norm)                -> m = (storage - 1) / 1.5
  icws  : 1.5 per sample + 1 (norm)                -> m = (storage - 1) / 1.5
  dmh   : 1.5 per sample + 1 (norm)                -> m = (storage - 1) / 1.5
  ts/ps : 1 per slot (i32 key + f32 val) + 1 (tau) -> slots = storage - 1
"""
from __future__ import annotations

from typing import Callable, Dict

from .dmh import DMH
from .icws import ICWS
from .kmv import KMV
from .linear import REPS, JL, CountSketch
from .minhash import MinHash
from .sampling import PrioritySamplingU32, ThresholdSamplingU32
from .wmh import DEFAULT_L, WeightedMinHash


def make_jl(storage: float, seed: int = 0):
    return JL(m=max(1, int(storage)), seed=seed)


def make_cs(storage: float, seed: int = 0):
    return CountSketch(width=max(1, int(storage // REPS)), seed=seed)


def make_mh(storage: float, seed: int = 0):
    return MinHash(m=max(1, int(storage / 1.5)), seed=seed)


def make_kmv(storage: float, seed: int = 0):
    return KMV(k=max(1, int(storage / 1.5)), seed=seed)


def make_wmh(storage: float, seed: int = 0, L: int = DEFAULT_L):
    return WeightedMinHash(m=max(1, int((storage - 1) / 1.5)), seed=seed, L=L)


def make_icws(storage: float, seed: int = 0):
    return ICWS(m=max(1, int((storage - 1) / 1.5)), seed=seed)


def make_dmh(storage: float, seed: int = 0):
    # ICWS's wire layout and accounting: only ingest differs
    return DMH(m=max(1, int((storage - 1) / 1.5)), seed=seed)


def make_ts(storage: float, seed: int = 0):
    return ThresholdSamplingU32(slots=max(1, int(storage - 1)), seed=seed)


def make_ps(storage: float, seed: int = 0):
    return PrioritySamplingU32(slots=max(1, int(storage - 1)), seed=seed)


FACTORIES: Dict[str, Callable] = {
    "jl": make_jl,
    "cs": make_cs,
    "mh": make_mh,
    "kmv": make_kmv,
    "wmh": make_wmh,
    "icws": make_icws,
    "dmh": make_dmh,
    "ts": make_ts,
    "ps": make_ps,
}

# the five methods of the paper's plots
PAPER_METHODS = ("jl", "cs", "mh", "kmv", "wmh")


def make(method: str, storage: float, seed: int = 0):
    return FACTORIES[method](storage, seed=seed)
