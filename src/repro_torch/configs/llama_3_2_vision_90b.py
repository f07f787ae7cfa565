"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-90B-Vision pattern].

100 layers = 80 self-attention + 20 cross-attention (every 5th layer cross);
vision frontend is a STUB: input_specs provides precomputed patch embeddings
(B, 1601, d_model) that the cross-attn layers attend to.
"""
import torch
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-90b", family="vlm", block_kind="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    cross_every=5, n_image_tokens=1601,
    rope_theta=5e5, dtype=torch.bfloat16, tie_embeddings=False,
    notes="cross-attn image layers; vision encoder stubbed",
))
