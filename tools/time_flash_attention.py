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
Each case's run also digests its kernel's output on inputs made from a
seed by the case's label, so that checkouts whose kernels should agree bit
for bit can be seen to.  Prints the card's name and power limit, each
run's lines, and a table of device ms and output digest per case and run.
Needs one card.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys
import zlib

TAG = "FLASH_CASES_JSON "


def output_digest(kfa, label, H, K, D, dtype, window, T):
    """The first 16 hex digits of the SHA-256 of the kernel's output bits on
    q, k, v drawn from a generator seeded by the case's label."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(zlib.crc32(label.encode()))
    q, k, v = (torch.randn((n, T, D), generator=gen, device="cuda").to(dtype)
               for n in (H, K, K))
    out = kfa.flash_attention_cuda(q, k, v, group=H // K, causal=True,
                                   window=window)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    digest = hashlib.sha256(out.view(bits).cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def child(root: pathlib.Path) -> None:
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from repro_torch.kernels import flash_attention as kfa
    chip_smoke.build_phase()
    reports, _ = chip_smoke.flash_attention_kernel_phase()
    for rep, (label, H, K, D, dtype, window, _) in zip(reports,
                                                      chip_smoke.FLASH_CASES):
        rep["bits"] = output_digest(kfa, label, H, K, D, dtype, window,
                                    chip_smoke.FLASH_T)
    print(TAG + json.dumps(reports), flush=True)


def turns(script: str, roots, tag: str, row, child_args=()) -> int:
    """Run ``script --child ROOT *child_args`` for each root in a fresh
    process, in the order given and then in reverse, print each run's lines,
    then one line per case (the ``shape`` of each report a child prints
    after ``tag``) with ``row(root, report)`` of every run, and the card."""
    roots = [pathlib.Path(r).resolve() for r in roots]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    table = {}
    for i, root in enumerate(roots + roots[::-1]):
        out = subprocess.run([sys.executable, script, "--child", str(root),
                              *child_args], capture_output=True, text=True)
        print(f"== run {i} {root} (rc {out.returncode})\n"
              + "\n".join(l for l in out.stdout.splitlines()
                          if not l.startswith(tag))
              + "\n" + out.stderr[-2000:], flush=True)
        if out.returncode:
            return out.returncode
        line = next(l for l in out.stdout.splitlines() if l.startswith(tag))
        for r in json.loads(line[len(tag):]):
            table.setdefault(r["shape"], []).append(row(root, r))
    for shape, runs in table.items():
        print(f"{shape}: " + "; ".join(runs))
    print(f"on {card}")
    return 0


def main(roots) -> int:
    return turns(__file__, roots, TAG, lambda root, r: (
        f"{root.name} {r['kernel']}"
        + (f" ({r['loads']})" if "loads" in r else "")
        + f" {r['device_ms']:.4f} {r['bits']}"))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(pathlib.Path(sys.argv[2]).resolve())
    else:
        sys.exit(main(sys.argv[1:]))
