"""Serving launcher: batched greedy decode of a dense, moe or vlm model
(a vlm decodes text only) through the ``ServeEngine`` (the port of
``repro/launch/serve.py``), on the card unless ``--device cpu``.

Usage:
  python -m repro_torch.launch.serve --arch tinyllama-1.1b --requests 6
  python -m repro_torch.launch.serve --arch tinyllama-1.1b --full
  python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --full --layers 8

As in JAX, the model is the architecture's reduced config unless
``--full`` asks for the published one; ``--layers`` cuts its depth (the
widths stay).  On the card, a model whose f32 parameters exceed the free
memory raises ``MemoryError`` before it allocates.  Weights are random,
drawn from a generator seeded 0.  ``--dry-run`` (with ``--shape``, ``--multi-pod``)
lowers the production cell through XLA HLO in JAX
(``repro/launch/dryrun.py``), which has no PyTorch counterpart: here it
raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.serve.engine import Request, ServeEngine


def serve(arch: str, *, requests: int = 6, slots: int = 4,
          max_new_tokens: int = 8, full: bool = False,
          layers: Optional[int] = None, device="cuda"):
    """Serves ``requests`` prompts ``[1 + i, 2 + i]`` on ``slots`` slots
    of a 128-position cache, as JAX's launcher, with the config's first
    ``layers`` layers (all of them by default).  Returns the requests and
    the seconds the engine took to drain them."""
    dev = resolve_device(device)
    cfg = configs.get(arch) if full else configs.reduced(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(model, params, batch_slots=slots, max_seq=128)
    reqs = [Request(rid=i, prompt=[1 + i, 2 + i],
                    max_new_tokens=max_new_tokens) for i in range(requests)]
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    ticks = 0
    while any(not r.done for r in reqs) and ticks < 10_000:
        engine.tick()
        ticks += 1
    return reqs, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the reduced one")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the config's first LAYERS layers")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.dry_run:
        raise NotImplementedError(
            "--dry-run lowers the production cell through XLA HLO "
            "(repro/launch/dryrun.py), which has no PyTorch counterpart; "
            "run it with python -m repro.launch.serve")
    reqs, seconds = serve(args.arch, requests=args.requests, slots=args.slots,
                          max_new_tokens=args.max_new_tokens, full=args.full,
                          layers=args.layers, device=args.device)
    toks = sum(len(r.output) for r in reqs)
    where = (torch.cuda.get_device_name(0) if resolve_device(args.device).type
             == "cuda" else "cpu")
    print(f"{args.arch}: served {len(reqs)} requests / {toks} tokens "
          f"in {seconds:.2f}s on {where}")


if __name__ == "__main__":
    main()
