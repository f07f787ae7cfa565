"""starcoder2-7b [arXiv:2402.19173]: GQA kv=4, RoPE.

Upstream uses a 4k sliding window; this config is plain GQA + RoPE, so
the default is global attention (long_500k skipped). Set window=4096
to reproduce the upstream SWA variant.
"""
import torch
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-7b", family="dense", block_kind="gqa",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432, vocab_size=49152,
    mlp_gated=False, mlp_act="gelu", rope_theta=1e5, dtype=torch.bfloat16,
    notes="non-gated GELU MLP (d_ff=4d)",
))
