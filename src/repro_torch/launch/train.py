"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --reduced --steps 200 --batch 8 --seq 128

Runs on ``cuda:0`` unless ``--device`` names another (``--device cpu`` on
a host without a card).  --reduced trains the smoke-size config, without
remat as in the reference; the full config remats every layer.  Sharded
training (``--mesh``) waits for ``models/sharding.py`` (``ROADMAP.md``
queue 1, item 7d).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models.model import Model
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--checkpoint-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="e.g. '4x2' => data x model over visible devices "
                         "(not yet in the port)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0; 'cpu' on a host "
                         "without a card)")
    args = ap.parse_args(argv)

    if args.mesh:
        ap.error("--mesh: sharded training comes with models/sharding.py "
                 "(ROADMAP.md queue 1 item 7d)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{args.device}: no CUDA device (pass --device "
                           "cpu to train on the CPU)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=device, remat=not args.reduced)
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
        n_codebooks=cfg.n_codebooks))
    tcfg = TrainConfig(
        steps=args.steps, microbatches=args.microbatches,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        grad_compression=args.grad_compression,
        opt=OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps))
    trainer = Trainer(model, data, tcfg)
    out = trainer.run(gen=torch.Generator(device).manual_seed(args.seed))
    print(f"[train] finished at step {out['step']} loss={out['loss']:.4f} "
          f"stragglers={out['stragglers']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
