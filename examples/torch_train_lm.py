"""End-to-end training driver: a ~100M-param qwen3-family model trained for a
few hundred steps on the deterministic synthetic pipeline, with
checkpoint/restart and preemption handling active, on ``cuda:0``
(``--device cpu`` on a host without a card).

On the CPU the default runs a ~20M variant so a few hundred steps finish in
minutes; pass --full-100m on the card for the 100M config. Resume works
across invocations: re-running continues from the last checkpoint.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 300
"""

import argparse
import os
import tempfile
from dataclasses import replace

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models.model import Model
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def variant_config(full_100m: bool):
    """The qwen3-1.7b family cut to ~100M parameters, or to ~20M."""
    base = get_config("qwen3-1.7b")
    if full_100m:
        return replace(base, n_layers=10, d_model=640, n_heads=10,
                       n_kv_heads=5, head_dim=64, d_ff=2560,
                       vocab_size=49152)
    return replace(base, n_layers=6, d_model=256, n_heads=8, n_kv_heads=4,
                   head_dim=32, d_ff=1024, vocab_size=8192)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0; 'cpu' on a host "
                         "without a card)")
    args = ap.parse_args(argv)

    cfg = variant_config(args.full_100m)
    model = Model(cfg, device=args.device, remat=False)
    n_params = sum(p.numel() for p in model.abstract_params().parameters())
    print(f"[train_lm] {cfg.name} variant: {n_params/1e6:.1f}M params")

    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch))
    tcfg = TrainConfig(steps=args.steps, checkpoint_every=100,
                       checkpoint_dir=args.ckpt, log_every=20,
                       opt=OptConfig(lr=1e-3, warmup_steps=20,
                                     total_steps=args.steps))
    out = Trainer(model, data, tcfg).run(verbose=True)
    print(f"[train_lm] done: step={out['step']} final loss={out['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
