"""deepseek-v2-lite-16b [arXiv:2405.04434].

MoE 64 routed experts top-6 + 2 shared (DeepSeek-V2-Lite; the full V2
has 160 routed), layer 0 dense (d_ff 10944). MLA: kv_lora=512, nope 128 + rope 64, v 128.
"""
import torch
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-lite-16b", family="moe", block_kind="mla_moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=192,
    d_ff=0, d_ff_expert=1408, d_ff_dense=10944, first_dense_layers=1,
    vocab_size=102400, n_experts=64, n_shared_experts=2, top_k=6,
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    rope_theta=1e4, dtype=torch.bfloat16,
    notes="MLA absorbed decode caches (c_kv 512 + k_rope 64) per token",
))
