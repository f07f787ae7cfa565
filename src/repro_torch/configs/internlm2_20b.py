"""internlm2-20b [arXiv:2403.17297]."""
import torch
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internlm2-20b", family="dense", block_kind="gqa",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92544,
    rope_theta=1e6, dtype=torch.bfloat16,
    notes="GQA kv=8, SwiGLU",
))
