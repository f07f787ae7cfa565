"""gemma3-27b [hf:google/gemma-3-27b-pt pattern].

5:1 local:global attention (window 1024, global every 6th layer), qk-norm.
sub_quadratic: local layers bound KV; global-layer KV is sequence-sharded
for long_500k decode.
"""
import torch
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-27b", family="dense", block_kind="gemma",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144,
    qk_norm=True, window=1024, global_every=6,
    mlp_act="gelu", rope_theta=1e4, dtype=torch.bfloat16,
    sub_quadratic=True,
    notes="5:1 local:global; 128k context target",
))
