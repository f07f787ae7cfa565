"""Mixture-of-Experts FFN with token-choice top-k routing.

The reference package's ``models/moe.py``.  Two entry modes:

- ``ep_axis=None``: one device (or data parallel only); the local experts
  are all the experts, no collective;
- ``ep_axis=(device mesh, mesh dim)`` inside the model's expert-parallel
  island (``Model._moe``): the expert tables are this rank's slice
  ``[expert_offset, expert_offset + E_local)`` of ``n_experts_total``;
  the capacity comes from the total, the output (and the shared experts'
  partial output, their ``d_ff`` sharded over the axis) is summed over
  the axis and ``aux`` averaged over it.

Dispatch
is sort-free: for each expert a cumsum over the routing mask, in token
order, gives each routed token its capacity slot; overflow tokens go to a
trash row (slot ``cap``) and are dropped.  Every expert runs on its own
``(cap + 1, d)`` buffer and the weighted outputs are summed over experts;
the experts run as one batched product over the expert axis, which is the
reference's per-expert map with the same arithmetic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, Dense, _init, _param, init_mlp, mlp
from .sharding import pmean, psum


class MoE(nn.Module):
    def __init__(self, router: Dense, up, gate, down, shared: MLP | None = None):
        super().__init__()
        self.router = router
        self.up, self.gate, self.down = _param(up), _param(gate), _param(down)
        if shared is not None:
            self.shared = shared


def init_moe(gen, d: int, d_ff: int, n_experts: int, n_shared: int = 0,
             d_ff_shared: int | None = None) -> MoE:
    router = Dense(_init(gen, (d, n_experts), scale=d ** -0.5))
    up = _init(gen, (n_experts, d, d_ff))
    gate = _init(gen, (n_experts, d, d_ff))
    down = _init(gen, (n_experts, d_ff, d))
    shared = None
    if n_shared:
        shared = init_mlp(gen, d, d_ff_shared or d_ff * n_shared, gated=True)
    return MoE(router, up, gate, down, shared)


def _route(router_w: torch.Tensor, x: torch.Tensor, top_k: int):
    """x: (T, d) -> (top_idx (T, k), top_w (T, k) renormalized in float32
    and cast to x's dtype, the Switch load-balancing aux loss)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(probs, top_k, dim=-1)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    e = router_w.shape[-1]
    me = probs.mean(0)
    one_hot = F.one_hot(top_idx, e).float().sum(1)  # (T, E)
    fe = one_hot.mean(0)
    aux = e * (fe * me).sum()
    return top_idx, top_w.to(x.dtype), aux


def moe_ffn(p: MoE, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, ep_axis=None,
            expert_offset: int = 0, n_experts_total: int | None = None):
    """x: (B, S, d).  Returns (y, aux_loss).  With ``ep_axis`` the expert
    tables in ``p`` are this rank's ``E_local`` experts from
    ``expert_offset`` and ``y`` is summed over the axis."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    e = p.up.shape[0]
    e_total = n_experts_total or e
    top_idx, top_w, aux = _route(p.router.w, xt, top_k)
    cap = int(t * top_k / e_total * capacity_factor) or 1

    eids = expert_offset + torch.arange(e, device=x.device)
    sel = top_idx[None] == eids[:, None, None]          # (E, T, k)
    w_tok = (top_w[None] * sel).sum(-1)                  # (E, T)
    routed = sel.any(-1)                                 # (E, T)
    pos = torch.cumsum(routed, dim=-1) - 1               # slot per routed token
    keep = routed & (pos < cap)
    slot = torch.where(keep, pos, cap)                   # overflow -> trash row
    rows = slot[..., None].expand(e, t, d)
    buf = torch.zeros((e, cap + 1, d), dtype=xt.dtype, device=x.device)
    buf.scatter_(1, rows, torch.where(keep[..., None], xt[None], 0))
    dt = xt.dtype
    h = F.silu(torch.bmm(buf, p.gate.to(dt))) * torch.bmm(buf, p.up.to(dt))
    out = torch.bmm(h, p.down.to(dt))                    # (E, cap + 1, d)
    y_tok = torch.gather(out, 1, rows) * (keep * w_tok)[..., None]
    y = y_tok.sum(0)

    if hasattr(p, "shared"):
        # with ep_axis the shared experts' d_ff is sharded over the axis:
        # a partial output, summed with the routed experts'
        y = y + mlp(p.shared, x, gated=True).reshape(t, d)
    if ep_axis is not None:
        mesh, dim = ep_axis
        y = psum(y, ep_axis)
        aux = pmean(aux, ep_axis, mesh.shape[dim])
    return y.reshape(b, s, d), aux
