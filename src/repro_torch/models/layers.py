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
  (its structure, no storage);
- on a mesh the parameters and activations are DTensors and these
  functions run on them unchanged: DTensor's propagation picks each op's
  layout (the vocab-parallel embedding is ``F.embedding``'s masked
  partial); a plain table meeting a DTensor (the rope tables) is made a
  replicated one (``sharding.like``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .sharding import grad_in_layout, is_dtensor, like


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


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """``x`` gathered along its middle dims where it is a DTensor sharded
    there (the SP residual's sequence): once before the products that read
    it, as Megatron-SP's all-gather, instead of once a product."""
    return _whole_middle(x) if is_dtensor(x) else x


def _whole_middle(x):
    """DTensor ``x`` gathered along any dim between its first and last."""
    from torch.distributed.tensor import Replicate, Shard

    middle = [isinstance(p, Shard) and 0 < p.dim % x.ndim < x.ndim - 1
              for p in x.placements]
    if not any(middle):
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate() if m else p
                           for p, m in zip(x.placements, middle)])


class _WholeMiddleGrad(torch.autograd.Function):
    """The identity, whose backward gathers the gradient's middle dims
    (a product's output may take the SP residual's sequence-sharded
    gradient, which its backward flattens)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _whole_middle(g)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``.  A DTensor ``x`` sharded on a middle dim (the sequence
    of the SP residual) is gathered along it first, as Megatron-SP gathers
    the sequence before a column-parallel product, and so is the output's
    gradient: the product flattens the leading dims, which DTensor does
    only where the first is the one sharded."""
    if not is_dtensor(x):
        return x @ w
    out = _whole_middle(x) @ w
    return _WholeMiddleGrad.apply(out) if out.ndim > 2 else out


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    return matmul(x, p.w.to(x.dtype))


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
    x = gather_seq(x)
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
    c = like(cos[..., None, :].to(x.dtype), x)  # broadcast over the heads
    s = like(sin[..., None, :].to(x.dtype), x)
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
          dtype=torch.bfloat16, sharder=None) -> torch.Tensor:
    """The rows of the table (cast to ``dtype``) at ``tokens``.  On a mesh
    (``sharder``) a vocab-parallel island: each rank looks up the tokens
    of its vocabulary slice (zeros elsewhere) and the rows are summed over
    tp; the table's d axis is gathered over its FSDP axis first."""
    if sharder is None or sharder.mesh is None:
        return p.table.to(dtype)[tokens.long()]
    table = grad_in_layout(p.table).to(dtype)
    from .sharding import island, psum

    vocab = table.shape[0]
    v_ok = vocab % sharder.tp_size == 0
    b_ok = tokens.shape[0] % sharder.dp_size == 0
    bspec = (sharder.dp if b_ok else None,) + (None,) * (tokens.ndim - 1)
    v_loc = vocab // sharder.tp_size if v_ok else vocab
    v0 = sharder.index(sharder.tp) * v_loc if v_ok else 0

    def body(tok, tab):
        tok = tok.long()
        if not v_ok:
            return F.embedding(tok, tab)
        ids = tok - v0
        mine = (ids >= 0) & (ids < v_loc)
        rows = F.embedding(torch.where(mine, ids, 0), tab)
        rows = rows * mine[..., None].to(rows.dtype)
        return psum(rows, sharder.group(sharder.tp))
    return island(sharder, body, (tokens, table),
                  (bspec, (sharder.tp if v_ok else None, None)),
                  bspec + (None,))


def unembed(p: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits against the embedding table (or a separate lm head table)."""
    return matmul(x, grad_in_layout(p.table).to(x.dtype).T)
