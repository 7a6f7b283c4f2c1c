"""Batched serving example on the PyTorch port (``examples/serve_lm.py``'s
counterpart): the ServeEngine admits queued requests into a fixed slot
batch and decodes them together (static batching with slot retirement).
Runs on the card; ``--device cpu`` runs the same code on the CPU.
``--arch`` takes any architecture of the dense, moe or vlm family (its
reduced config; a vlm decodes text only).

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--arch NAME] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import configs
from repro_torch.models import Model
from repro_torch.serve.engine import Request, ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = configs.reduced(args.arch)
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    engine = ServeEngine(model, params, batch_slots=4, max_seq=64)

    reqs = [Request(rid=i, prompt=[1 + i, 2 + i, 3 + i], max_new_tokens=8)
            for i in range(6)]                      # 6 requests > 4 slots
    for r in reqs:
        engine.submit(r)

    t0 = time.time()
    ticks = 0
    while any(not r.done for r in reqs):
        engine.tick()
        ticks += 1
        if ticks > 200:
            raise RuntimeError("engine did not drain")
    dt = time.time() - t0

    total_tokens = sum(len(r.output) for r in reqs)
    where = (torch.cuda.get_device_name(0) if model.device.type == "cuda"
             else "CPU")
    print(f"served {len(reqs)} requests / {total_tokens} tokens "
          f"in {ticks} ticks ({dt:.2f}s, {total_tokens/dt:.1f} tok/s on "
          f"{where})")
    for r in reqs:
        print(f"  req {r.rid}: prompt={r.prompt} -> output={r.output}")


if __name__ == "__main__":
    main()
