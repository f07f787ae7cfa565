"""Shared model layers: the reference package's ``models/layers.py`` on
torch.  Each layer is a function ``fn(p, x, ...) -> y`` of a small
``nn.Module`` that holds its parameters under the reference's names
(``w``, ``scale``, ``table``; an MLP's ``up`` / ``gate`` / ``down``), in its
``(d_in, d_out)`` layout, so a reference parameter tree maps onto the
modules one to one (``models/convert.py``).

Conventions:
- the compute dtype is the activation dtype (bf16 in production configs);
  reductions (norms, softmax) run in float32;
- weights are stored in float32 and cast to the activation dtype at use,
  which is a no-op once a caller has cast them (``Model.cast_params``);
- ``init_*`` draw from an explicit ``torch.Generator`` on the device the
  weights live on; ``gen=None`` builds the module on the ``meta`` device
  (its structure, no storage).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _device(gen: torch.Generator | None) -> torch.device:
    return torch.device("meta") if gen is None else gen.device


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _init(gen, shape, scale: float | None = None,
          dtype=torch.float32) -> torch.Tensor:
    """Normal weights scaled by ``scale``, by default ``shape[0] ** -0.5``
    (the reference's fan-in, the leading axis even for a stacked expert
    table)."""
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


class Node(nn.Module):
    """A parameter subtree: each keyword a submodule or a tensor (held as
    a frozen parameter) under the reference's name."""

    def __init__(self, /, **parts):
        super().__init__()
        for name, part in parts.items():
            setattr(self, name,
                    part if isinstance(part, nn.Module) else _param(part))


# --------------------------------------------------------------------------
# norm
# --------------------------------------------------------------------------
class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)


def init_rmsnorm(d: int, gen: torch.Generator | None = None) -> RMSNorm:
    return RMSNorm(torch.ones((d,), dtype=torch.float32, device=_device(gen)))


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p.scale.float()
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# dense / mlp
# --------------------------------------------------------------------------
class Dense(nn.Module):
    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = _param(w)


def init_dense(gen, d_in: int, d_out: int,
               scale: float | None = None) -> Dense:
    return Dense(_init(gen, (d_in, d_out), scale))


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    return x @ p.w.to(x.dtype)


class MLP(nn.Module):
    def __init__(self, up: Dense, down: Dense, gate: Dense | None = None):
        super().__init__()
        self.up = up
        self.down = down
        if gate is not None:
            self.gate = gate


def init_mlp(gen, d: int, d_ff: int, gated: bool = True) -> MLP:
    up = init_dense(gen, d, d_ff)
    down = init_dense(gen, d_ff, d)
    return MLP(up, down, init_dense(gen, d, d_ff) if gated else None)


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTS = {"silu": F.silu, "gelu": _gelu}


def mlp(p: MLP, x: torch.Tensor, *, gated: bool = True,
        act: str = "silu") -> torch.Tensor:
    a = ACTS[act]
    up = dense(p.up, x)
    h = a(dense(p.gate, x)) * up if gated else a(up)
    return dense(p.down, h)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float = 1e4) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 cos/sin tables for integer positions: each
    ``(..., head_dim/2)``."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (S, D/2) (or broadcastable).  Each head
    splits in half (not interleaved)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)  # broadcast over the head axis
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------
class Embedding(nn.Module):
    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = _param(table)


def init_embedding(gen, vocab: int, d: int) -> Embedding:
    return Embedding(_init(gen, (vocab, d), scale=1.0))


def embed(p: Embedding, tokens: torch.Tensor,
          dtype=torch.bfloat16) -> torch.Tensor:
    return p.table.to(dtype)[tokens.long()]


def unembed(p: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits against the embedding table (or a separate lm head table)."""
    return x @ p.table.to(x.dtype).T
