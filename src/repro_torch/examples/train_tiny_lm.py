"""End-to-end training example: a dense LM through the full stack (data
pipeline -> model -> AdamW + cosine -> the fused train step -> async
checkpoints -> fault-tolerant supervisor).

Port of ``examples/train_tiny_lm.py``. The default runs the reduced
qwen2.5-3b (60 steps; the loss must fall). ``--full`` trains a ~100M-param
config (d 768, 12 layers, vocab 32k), registered through the port's config
registry as ``tiny-lm-100m``.

Run on the card:  PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm [--full --steps 300]
Run on the CPU:   add ``--device cpu`` (without a card and without it, it raises).
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train as train_mod

TINY_100M = ModelConfig(
    name="tiny-lm-100m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=32000,
    remat="none", dtype="float32")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params (d=768, L=12, vocab=32k)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    common = ["--steps", str(args.steps), "--batch", str(args.batch),
              "--seq", str(args.seq), "--device", args.device]
    if args.ckpt_dir:
        common += ["--ckpt-dir", args.ckpt_dir]
    if args.full:
        if TINY_100M.name not in configs.archs():
            configs.register(TINY_100M)
        return train_mod.main(["--arch", TINY_100M.name, *common])
    return train_mod.main(["--arch", "qwen2.5-3b", "--smoke", *common])


if __name__ == "__main__":
    raise SystemExit(main())
