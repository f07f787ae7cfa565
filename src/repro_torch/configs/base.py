"""ArchConfig: one dataclass describes every LM architecture; the
model (``models/model.py``) dispatches on ``block_kind``.

The reference package's ``configs/base.py`` with torch dtypes.  Shapes:
each architecture runs the same four input shapes; ``input_specs``
returns ``meta``-device tensors as stand-ins (no allocation).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | vlm | ssm | hybrid | audio
    block_kind: str                # gqa | gqa_moe | mla_moe | gemma | vlm | xlstm | hymba | musicgen
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention details
    qk_norm: bool = False
    rope_theta: float = 1e4
    window: int = 0                # sliding-window size (0 = global)
    global_every: int = 0          # every k-th layer global (gemma/hymba pattern)
    mlp_gated: bool = True
    mlp_act: str = "silu"
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    d_ff_dense: int = 0
    capacity_factor: float = 1.25
    # MLA
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    d_inner: int = 0
    conv_kernel: int = 4
    n_meta_tokens: int = 0
    # VLM
    cross_every: int = 0           # every k-th layer is cross-attention
    n_image_tokens: int = 0
    # audio
    n_codebooks: int = 0
    # misc
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16
    sub_quadratic: bool = False    # can run long_500k
    notes: str = ""

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 4) if self.block_kind != "vlm" else 5,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(self.n_heads, 1)) or 1),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2),
            d_ff_expert=32 if self.d_ff_expert else 0,
            d_ff_dense=128 if self.d_ff_dense else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_dim=16 if self.qk_nope_dim else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            d_inner=128 if self.d_inner else 0,
            n_meta_tokens=min(self.n_meta_tokens, 8),
            n_image_tokens=min(self.n_image_tokens, 16) if self.n_image_tokens else 0,
            cross_every=self.cross_every,
            global_every=self.global_every,
            window=min(self.window, 16) if self.window else 0,
        )
        small.update(overrides)
        return replace(self, **small)


# --------------------------------------------------------------------------
# shapes
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_supported(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "skip(full-attn)"
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: str) -> dict[str, torch.Tensor]:
    """``meta`` tensors standing in for every model input of a shape."""
    sp = SHAPES[shape]
    b, s = sp.global_batch, sp.seq_len
    i32 = torch.int32
    tok_shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    specs: dict[str, torch.Tensor] = {}
    if sp.mode in ("train", "prefill"):
        specs["tokens"] = _spec(tok_shape, i32)
    else:  # decode: one new token, cache of length s
        one = (b, 1, cfg.n_codebooks) if cfg.n_codebooks else (b, 1)
        specs["tokens"] = _spec(one, i32)
        specs["pos"] = _spec((), i32)
    if cfg.block_kind == "vlm":
        specs["image_embeds"] = _spec((b, cfg.n_image_tokens, cfg.d_model),
                                      cfg.dtype)
    return specs


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
_REGISTRY: dict[str, ArchConfig] = {}

CONFIG_MODULES = ("granite_moe_1b_a400m", "deepseek_v2_lite_16b",
                  "gemma3_27b", "starcoder2_7b", "qwen3_1_7b",
                  "internlm2_20b", "llama_3_2_vision_90b", "xlstm_350m",
                  "hymba_1_5b", "musicgen_medium")


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    from importlib import import_module
    for mod in CONFIG_MODULES:
        import_module(f"repro_torch.configs.{mod}")
