"""AdamW + cosine schedule + global-norm clipping, hand-rolled.

The reference package's ``train/optimizer.py`` as plain functions on
tensors.  Parameters are the model's ``Params`` module (or any mapping of
names to tensors); gradients and the moments are dicts keyed by the same
state-dict names; the state is ``{"m", "v", "step"}`` with ``step`` an
int32 scalar on the host, so the schedule costs the device nothing.  The
update runs as ``torch._foreach_*`` over every leaf at once, in place: the
parameters and moments passed in are the ones returned.

The arithmetic is the reference's: the clip scale ``min(1, clip_norm /
(gnorm + 1e-9))``, ``m / bc1 / (sqrt(v / bc2) + eps)``, the decoupled
decay inside ``lr * update``.  ``torch.optim.AdamW`` differs in the clip's
epsilon and the decay mask.

The decay mask is the reference's as it behaves, not as its comment
reads ("no decay on norms"): it decays a leaf of rank >= 2, tested on the
*stacked* leaf, whose leading layer axis (two for vlm's ``units.self``)
makes every per-layer norm scale rank 2.  So every norm inside a stack is
decayed and only top-level vectors (``final_norm.scale``) are not.  The
port keeps one tensor per layer and takes the rank the reference sees
(``ROADMAP.md`` queue 3, fault 7 of the reference), so that the two
packages' trajectories compare.

On a mesh the parameters, the gradients and the moments are DTensors of
one layout per leaf (``sharding.param_specs``).  The update is elementwise,
so it runs on each rank's local pieces; only the clip's norm needs the
whole tree: each rank sums the squares of its pieces, a leaf replicated
over some mesh axes counted once, and one all-reduce sums them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.convert import named_tensors, reference_key
from repro_torch.models.sharding import is_dtensor, local


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine to ``min_lr_frac * lr`` at
    ``total_steps``: a float32 scalar on the host."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = cfg.lr * (s + 1) / max(cfg.warmup_steps, 1)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * frac))
    return torch.where(s < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params) -> dict:
    """Zero float32 moments beside each parameter, and step 0."""
    named = named_tensors(params)
    zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                     for k, p in named.items()}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf together, in float32 (a plain tensor).
    DTensor leaves count their whole global tensor: each rank's squares
    over its pieces, divided by the number of ranks holding the same
    piece, summed over the mesh."""
    leaves = list(named_tensors(tree).values())
    if not any(is_dtensor(g) for g in leaves):
        leaves = [g.float() for g in leaves]
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(leaves)))
    from torch.distributed.tensor import Shard

    from repro_torch.models.sharding import all_reduce_nograd

    mesh = next(g for g in leaves if is_dtensor(g)).device_mesh
    norms = torch._foreach_norm([local(g).float() for g in leaves])
    # the ranks holding each piece: every rank for a plain leaf
    copies = [math.prod(mesh.size(i) for i, p in enumerate(g.placements)
                        if not isinstance(p, Shard))
              if is_dtensor(g) else mesh.size() for g in leaves]
    weights = [1.0 / c for c in copies]
    sq = torch.stack(norms) ** 2
    total = (sq * torch.tensor(weights, dtype=sq.dtype,
                               device=sq.device)).sum()
    for dim in range(mesh.ndim):
        total = all_reduce_nograd(total, "sum", (mesh, dim))
    return torch.sqrt(total)


def _decay_mask(params) -> dict[str, float]:
    """1.0 where the reference decays the leaf (its stacked rank >= 2),
    else 0.0, by state-dict name."""
    return {name: float(p.ndim + len(reference_key(name)[1]) >= 2)
            for name, p in named_tensors(params).items()}


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads: dict, state: dict):
    """One AdamW step.  Returns ``(params, state, metrics)``; the
    parameters and the moments are updated in place, ``state["step"]`` is
    a new scalar one higher, metrics hold ``grad_norm`` (on the gradients'
    device) and ``lr``."""
    named = named_tensors(params)
    names = list(named)
    p = [local(named[k]) for k in names]
    m = [local(state["m"][k]) for k in names]
    v = [local(state["v"][k]) for k in names]
    step = state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    t = (step + 1).float()
    bc1 = float(1 - torch.tensor(cfg.b1, dtype=torch.float32) ** t)
    bc2 = float(1 - torch.tensor(cfg.b2, dtype=torch.float32) ** t)

    g = torch._foreach_mul([local(grads[k]).float() for k in names], scale)
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, g, alpha=1 - cfg.b1)
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
    del g
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    update = torch._foreach_div(m, bc1)
    torch._foreach_div_(update, denom)
    del denom
    mask = _decay_mask(params)
    decayed = [i for i, k in enumerate(names) if mask[k]]
    if cfg.weight_decay and decayed:
        torch._foreach_add_([update[i] for i in decayed],
                            [p[i].float() for i in decayed],
                            alpha=cfg.weight_decay)
    # a low-precision leaf steps in float32 and rounds, as the reference
    torch._foreach_add_(p, update, alpha=-float(lr))
    new_state = {"m": state["m"], "v": state["v"], "step": step + 1}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
