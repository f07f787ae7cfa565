"""hymba-1.5b [arXiv:2411.13676]. Parallel attention+mamba heads per layer,
128 meta tokens, sliding window except 3 global layers (first/middle/last)."""
import torch
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b", family="hybrid", block_kind="hymba",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, d_inner=1600, conv_kernel=4, n_meta_tokens=128,
    window=1024, global_every=16,
    rope_theta=1e4, dtype=torch.bfloat16, sub_quadratic=True,
    notes="parallel attn+mamba; SWA + 3 global layers; meta tokens prepended",
))
