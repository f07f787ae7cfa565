"""musicgen-medium [arXiv:2306.05284]. Decoder-only over EnCodec tokens:
4 codebooks, sum-of-embeddings input, 4 output heads. Audio frontend
(EnCodec) is a STUB — input_specs provides the token grid (B, S, 4)."""
import torch
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-medium", family="audio", block_kind="musicgen",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    n_codebooks=4, mlp_gated=False, mlp_act="gelu",
    rope_theta=1e4, dtype=torch.bfloat16, tie_embeddings=False,
    notes="MHA (kv=24); delay-pattern handled in the data pipeline",
))
