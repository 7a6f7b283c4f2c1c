"""Instruction counts of a kernel's loops in the built library.

    python3 tools/sass_loops.py [SYMBOL [LIBRARY]]

Disassembles LIBRARY (default: the port's library, built first if need be)
with ``cuobjdump -sass`` and prints, for every function whose name
contains SYMBOL (default ``icws_sketch_kernel``), each loop (a backward
branch and its target): its own SASS instructions (those in no loop
nested inside it), its nested loops, its marker operations (MUFU, VOTE,
MATCH, FMUL, STS, ATOM, RED) and its most frequent opcodes.
:func:`per_unit` returns, per such function, the instructions of one
unit of work in the loop whose own instructions hold the most of the
kernel's marker opcode (``MARKERS``): its own instructions over its
markers, times the markers a unit takes.
``chip_smoke.py`` reports these beside the bounds as the kernels' issue
floors: B1's draw (two MUFU.EX2, the draw's two ``expf``), B7's term,
B6's and B14's term, B9's / B13's lookup and B5's lane.  Needs the CUDA
toolkit's ``cuobjdump``.
"""
from __future__ import annotations

import collections
import functools
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# (marker opcode, markers a unit[, opcode of loops to pass over]) of each
# kernel's hot loop: B1's draw takes two MUFU.EX2; B7's hash loop one STS a
# term (its signed value's store), B6's one FMUL a term (the sign times the
# value); B9's and B13's chunk loop one LDS.128 a lookup (its first
# bucket's four keys; further buckets are read in loops of their own); B5's
# lane loop two MUFU.EX2 a lane (the rank's two ``expf``), as its winners'
# loop, which alone takes shared-memory atomics (ATOMS) and is passed over;
# B14's batch loop one FMUL a term (the sign times the value)
MARKERS = {"icws_sketch_kernel": ("MUFU.EX2", 2),
           "countsketch_dense_partial_kernel": ("FMUL", 1),
           "jl_sketch_kernel": ("STS", 1),
           "countsketch_sparse_kernel": ("FMUL", 1),
           "sample_estimate_fields_kernel": ("LDS.128", 1),
           "sample_estimate_fields_packed_kernel": ("LDS.128", 1),
           "dmh_sketch_kernel": ("MUFU.EX2", 2, "ATOMS")}


def cuobjdump() -> str:
    from repro_torch.kernels import build
    tool = pathlib.Path(build.nvcc()).parent / "cuobjdump"
    return str(tool) if tool.exists() else (shutil.which("cuobjdump") or "")


def opcode(instruction: str) -> str:
    """The opcode of one SASS instruction, past its predicate guard."""
    words = instruction.split() or [""]
    return words[1] if words[0].startswith("@") else words[0]


@functools.lru_cache(maxsize=None)
def sass(library: str) -> str:
    """The SASS of every function in ``library`` (``cuobjdump -sass``: many
    seconds for the port's library, so one run a library and process)."""
    return subprocess.run([cuobjdump(), "-sass", library], capture_output=True,
                          text=True, check=True, timeout=600).stdout


def loops(library, symbol: str):
    """{function: [(own opcodes, nested loops) of each loop]}, innermost
    loops first."""
    text = sass(str(library))
    out = {}
    for part in re.split(r"(?m)^\s*Function : ", text)[1:]:
        name, _, body = part.partition("\n")
        if symbol not in name:
            continue
        ins = [(int(a, 16), t.strip()) for a, t in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        spans = sorted({(int(m.group(1), 16), a) for a, t in ins
                        for m in [re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", t)]
                        if m and int(m.group(1), 16) <= a},
                       key=lambda span: span[1] - span[0])
        found = []
        for lo, hi in spans:
            inner = [(l2, h2) for l2, h2 in spans if (l2, h2) != (lo, hi)
                     and lo <= l2 and h2 <= hi]
            own = [opcode(t) for a, t in ins if lo <= a <= hi
                   and not any(l2 <= a <= h2 for l2, h2 in inner)]
            found.append((own, len(inner)))
        out[name.strip()] = found
    return out


def per_unit(library, symbol: str):
    """{function: SASS instructions a unit of work}: of the loop whose own
    instructions hold the most opcodes that start with the symbol's marker
    (``MARKERS``; loops that hold its pass-over opcode count none), its own
    instructions over its markers, times the markers a unit."""
    marker, per, *skip = MARKERS[symbol]
    out = {}
    for name, found in loops(library, symbol).items():
        counts = [0 if any(op.startswith(tuple(skip)) for op in own) and skip
                  else sum(op.startswith(marker) for op in own)
                  for own, _ in found]
        if counts and max(counts):
            best = counts.index(max(counts))
            out[name] = len(found[best][0]) * per / counts[best]
    return out


def main(argv) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    symbol = argv[0] if argv else "icws_sketch_kernel"
    if len(argv) > 1:
        library = pathlib.Path(argv[1])
    else:
        build.library()
        library = build.library_path()
    for name, found in loops(library, symbol).items():
        print(name)
        for own, nested in found:
            marked = collections.Counter(op for op in own if op.startswith(
                ("MUFU", "VOTE", "MATCH", "FMUL", "STS", "ATOM", "RED")))
            common = collections.Counter(own).most_common(8)
            print(f"  loop: {len(own)} own instructions, {nested} nested "
                  f"loops; markers {dict(marked)}; most: {dict(common)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
