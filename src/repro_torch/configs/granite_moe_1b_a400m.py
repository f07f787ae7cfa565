"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
import torch
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m", family="moe", block_kind="gqa_moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=0, d_ff_expert=512, vocab_size=49155,
    n_experts=32, top_k=8,
    rope_theta=1e4, dtype=torch.bfloat16,
    notes="32 experts top-8; GQA kv=8; SwiGLU experts",
))
