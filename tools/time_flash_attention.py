"""B15's flash-attention cases of several checkouts, in turns on one card.

    python3 tools/time_flash_attention.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (``.`` for the working tree; a parent
unpacked with ``git archive`` into a git-ignored directory such as
``build/parent``).  The roots run in the order given and then in reverse
(A B, B A), each in a fresh process that builds that checkout's kernels
(under its own ``build/``) and runs its ``chip_smoke.py`` flash phase
(``flash_attention_kernel_phase``: every case of its ``FLASH_CASES`` held
against the plain version, per head == batched, timed under the symbol of
the kernel its route takes, beside ``scaled_dot_product_attention``).
Prints the card's name and power limit, each run's lines, and a table of
device ms per case and run.  Needs one card.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

TAG = "FLASH_CASES_JSON "


def child(root: pathlib.Path) -> None:
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    chip_smoke.build_phase()
    reports, _ = chip_smoke.flash_attention_kernel_phase()
    print(TAG + json.dumps(reports), flush=True)


def main(roots) -> int:
    roots = [pathlib.Path(r).resolve() for r in roots]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    table = {}
    for i, root in enumerate(roots + roots[::-1]):
        out = subprocess.run([sys.executable, __file__, "--child", str(root)],
                             capture_output=True, text=True)
        print(f"== run {i} {root} (rc {out.returncode})\n"
              + "\n".join(l for l in out.stdout.splitlines()
                          if not l.startswith(TAG))
              + "\n" + out.stderr[-2000:], flush=True)
        if out.returncode:
            return out.returncode
        line = next(l for l in out.stdout.splitlines() if l.startswith(TAG))
        for r in json.loads(line[len(TAG):]):
            table.setdefault(r["shape"], []).append(
                f"{root.name} {r['kernel']} {r['device_ms']:.4f}")
    for shape, runs in table.items():
        print(f"{shape}: " + "; ".join(runs))
    print(f"on {card}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(pathlib.Path(sys.argv[2]).resolve())
    else:
        sys.exit(main(sys.argv[1:]))
