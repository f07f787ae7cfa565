"""qwen3-1.7b [hf:Qwen/Qwen3-1.7B family]."""
import torch
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-1.7b", family="dense", block_kind="gqa",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, dtype=torch.bfloat16,
    notes="qk-norm GQA; tied embeddings",
))
