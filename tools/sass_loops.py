"""Instruction counts of a kernel's innermost loops in the built library.

    python3 tools/sass_loops.py [SYMBOL [LIBRARY]]

Disassembles LIBRARY (default: the port's library, built first if need be)
with ``cuobjdump -sass`` and prints, for every function whose name
contains SYMBOL (default ``icws_sketch_kernel``), each innermost loop (a
backward branch and its target that hold no other loop): its SASS
instructions and MUFU operations.  :func:`draw_loop` returns, per such
function, the instructions of the innermost loop that holds two MUFU.EX2
(the ICWS draw's two ``expf``: one draw an iteration); ``chip_smoke.py``
reports it beside B1's bound as the kernel's instruction floor.  Needs the CUDA
toolkit's ``cuobjdump``.
"""
from __future__ import annotations

import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def cuobjdump() -> str:
    from repro_torch.kernels import build
    tool = pathlib.Path(build.nvcc()).parent / "cuobjdump"
    return str(tool) if tool.exists() else (shutil.which("cuobjdump") or "")


def loops(library, symbol: str):
    """{function: [(instructions, MUFU opcodes) per innermost loop]}."""
    text = subprocess.run([cuobjdump(), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    out = {}
    for part in re.split(r"(?m)^\s*Function : ", text)[1:]:
        name, _, body = part.partition("\n")
        if symbol not in name:
            continue
        ins = [(int(a, 16), t.strip()) for a, t in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        spans = [(int(m.group(1), 16), a) for a, t in ins
                 for m in [re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", t)]
                 if m and int(m.group(1), 16) <= a]
        inner = [(lo, hi) for lo, hi in spans
                 if not any((lo, hi) != (l2, h2) and lo <= l2 and h2 <= hi
                            for l2, h2 in spans)]
        out[name.strip()] = [
            ([t for a, t in ins if lo <= a <= hi])
            for lo, hi in inner]
    return {name: [(len(body), [w for t in body for w in t.split()
                                if w.startswith("MUFU")])
                   for body in bodies] for name, bodies in out.items()}


def draw_loop(library, symbol: str = "icws_sketch_kernel"):
    """{function: instructions of its loop with two MUFU.EX2}."""
    return {name: n for name, found in loops(library, symbol).items()
            for n, mufu in found if mufu.count("MUFU.EX2") == 2}


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
        for n, mufu in found:
            print(f"  innermost loop: {n} instructions, "
                  f"{', '.join(mufu) or 'no MUFU'}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
