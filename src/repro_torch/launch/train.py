"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --reduced --steps 200 --batch 8 --seq 128

Runs on ``cuda:0`` unless ``--device`` names another (``--device cpu`` on
a host without a card).  --reduced trains the smoke-size config, without
remat as in the reference; the full config remats every layer.

``--mesh DxM`` trains sharded over the reference's axes (``data`` x
``model``; three numbers add ``pod`` first) on as many ranks: under
``torchrun`` (``torchrun --nproc-per-node 4 -m repro_torch.launch.train
--mesh 2x2 ...``, one card a rank, ``nccl``; ``--device cpu`` uses
``gloo``), in ranks a caller spawned with the default process group
already initialized, or on one card with ``--mesh 1x1`` (a one-rank
group starts itself).  Only rank 0 prints.
"""

from __future__ import annotations

import argparse
import math
import os

import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch.mesh import ensure_default_group, make_mesh, \
    rank_device
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
                    help="e.g. '4x2' => data x model over the ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0; 'cpu' on a host "
                         "without a card)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{args.device}: no CUDA device (pass --device "
                           "cpu to train on the CPU)")
    mesh = None
    if args.mesh:
        shape = tuple(int(v) for v in args.mesh.split("x"))
        axes = ("data", "model")[:len(shape)] if len(shape) <= 2 \
            else ("pod", "data", "model")
        _join(device)
        if dist.get_world_size() != math.prod(shape):
            ap.error(f"--mesh {args.mesh} needs {math.prod(shape)} ranks; "
                     f"the process group has {dist.get_world_size()}")
        mesh = make_mesh(shape, axes)
        device = rank_device(device)
    verbose = mesh is None or dist.get_rank() == 0
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, mesh=mesh, device=device, remat=not args.reduced)
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
    trainer = Trainer(model, data, tcfg, mesh=mesh)
    out = trainer.run(gen=torch.Generator(device).manual_seed(args.seed),
                      verbose=verbose)
    if verbose:
        print(f"[train] finished at step {out['step']} "
              f"loss={out['loss']:.4f} stragglers={out['stragglers']}")
    return 0


def _join(device: torch.device) -> None:
    """Join the default process group: already initialized (spawned
    ranks), from ``torchrun``'s environment, or a one-rank group."""
    if dist.is_initialized():
        return
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        if device.type == "cuda":
            dist.init_process_group("nccl", device_id=rank_device(device))
        else:
            dist.init_process_group("gloo")
        return
    ensure_default_group(device)


if __name__ == "__main__":
    raise SystemExit(main())
