"""Training launcher: the dense and moe families through the port's
``Trainer`` (the port of ``repro/launch/train.py``), on the card unless
``--device cpu``.

Usage:
  python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 50
  python -m repro_torch.launch.train --arch tinyllama-1.1b --full --steps 4
  python -m repro_torch.launch.train --arch mixtral-8x22b --steps 4

As in JAX, the model is the architecture's reduced config unless
``--full`` asks for the published one; weights are random, drawn from a
generator seeded 0.  encdec and vlm exit as JAX's launcher does; ssm and
hybrid are not ported yet (``Model`` raises, naming ROADMAP.md Queue A
18c).  ``--dry-run`` (with ``--multi-pod``) lowers the production cell
through XLA HLO in JAX (``repro/launch/dryrun.py``), which has no PyTorch
counterpart: here it raises.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def train(arch: str, *, steps: int = 50, global_batch: int = 8,
          seq: int = 128, microbatches: int = 2, ckpt_dir=None,
          full: bool = False, device="cuda", log_fn=print):
    """JAX's launcher run: ``steps`` steps at lr 1e-3 (10 warmup steps),
    SIGTERM checkpointing and exiting.  Returns the trainer's history."""
    dev = resolve_device(device)
    cfg = configs.get(arch) if full else configs.reduced(arch)
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit(f"{arch}: the token-stream trainer drives LM "
                         "families; use examples/ for multimodal stubs")
    tcfg = TrainerConfig(
        steps=steps, global_batch=global_batch, seq=seq,
        microbatches=microbatches, ckpt_dir=ckpt_dir,
        opt=AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps))
    trainer = Trainer(cfg, tcfg, log_fn=log_fn, device=dev)
    trainer.preemption.install()
    return trainer.run()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the reduced one")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.dry_run:
        raise NotImplementedError(
            "--dry-run lowers the production cell through XLA HLO "
            "(repro/launch/dryrun.py), which has no PyTorch counterpart; "
            "run it with python -m repro.launch.train")
    hist = train(args.arch, steps=args.steps, global_batch=args.global_batch,
                 seq=args.seq, microbatches=args.microbatches,
                 ckpt_dir=args.ckpt_dir, full=args.full, device=args.device)
    where = (torch.cuda.get_device_name(0) if resolve_device(args.device).type
             == "cuda" else "cpu")
    print(f"final loss {hist['loss'][-1]:.4f} "
          f"(start {hist['loss'][0]:.4f}) on {where}")


if __name__ == "__main__":
    main()
