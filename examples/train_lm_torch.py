"""End-to-end training on the PyTorch port (``examples/train_lm.py``'s
counterpart): a llama-family model trained on the deterministic synthetic
token stream, with async atomic checkpointing, preemption handling and
resumability.  Runs on the card; ``--device cpu`` runs the same code on
the CPU.  ``--arch`` takes a moe architecture too (qwen3-moe-30b-a3b,
mixtral-8x22b: its experts and top-k at the widths below).

Defaults are a ~10M-parameter model and 60 steps; pass ``--full`` for the
~100M / 300-step configuration.  Restart it with the same ``--ckpt-dir``
to resume from the newest checkpoint there.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--full] [--arch NAME] [--device cpu]
"""
import argparse
import dataclasses
import pathlib

from repro_torch import configs
from repro_torch.optim import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]


def model_for(full: bool, arch: str = "tinyllama-1.1b"):
    base = configs.reduced(arch)
    if full:
        # ~100M params: 12L x d768 (llama-family)
        return dataclasses.replace(
            base, num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=32000)
    # ~10M params for the CPU demo
    return dataclasses.replace(
        base, num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=688, vocab_size=4096)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=str(ROOT / "build" / "train_lm"))
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = model_for(args.full, args.arch)
    steps = args.steps or (300 if args.full else 60)
    tcfg = TrainerConfig(
        steps=steps,
        global_batch=8 if not args.full else 32,
        seq=128 if not args.full else 512,
        microbatches=2,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=max(steps // 3, 10),
        log_every=max(steps // 12, 1),
        opt=AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps),
    )
    print(f"model: {cfg.num_layers}L d{cfg.d_model} vocab {cfg.vocab_size} "
          f"(~{configs.get(args.arch).param_count()/1e9:.1f}B full-size arch, "
          f"reduced for this run)")
    trainer = Trainer(cfg, tcfg, device=args.device)
    trainer.preemption.install()
    hist = trainer.run()
    first, last = hist["loss"][0], hist["loss"][-1]
    print(f"\nloss: {first:.3f} -> {last:.3f} over {len(hist['loss'])} steps "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    print(f"checkpoints in {args.ckpt_dir} (restart me to resume from there)")


if __name__ == "__main__":
    main()
