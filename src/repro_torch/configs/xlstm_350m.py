"""xlstm-350m [arXiv:2405.04517]. Alternating mLSTM/sLSTM blocks (1:1),
no separate FFN (d_ff=0; blocks carry their own projections)."""
import torch
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-350m", family="ssm", block_kind="xlstm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304,
    conv_kernel=4, dtype=torch.bfloat16, sub_quadratic=True,
    notes="O(1)-state decode; chunkwise-parallel mLSTM for train/prefill",
))
