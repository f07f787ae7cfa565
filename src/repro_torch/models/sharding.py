"""Sharding rules: parameter name -> spec, the activation-constraint
helper, and the islands that run on each rank's local pieces.

The reference package's ``models/sharding.py`` over DTensor.  Baseline
layout: Megatron tensor parallelism on the ``model`` axis (attention
heads, d_ff, experts, vocab), ZeRO-3 FSDP on the ``data`` axis (the
largest non-TP dim of every weight), batch over (``pod``, ``data``).
DTensor's sharding propagation gathers the FSDP-sharded weights where an
op meets batch-sharded activations, as GSPMD does.

A spec is the reference's ``PartitionSpec`` as a tuple: one entry a
tensor dim, each ``None``, a mesh axis name, or a tuple of axis names
(major first).  The rules dispatch on the reference's ``/``-joined leaf
path and rank, so the port's per-layer leaves (``layers.3.attn.wq.w``) are
read as their stacked counterparts (``layers/attn/wq/w`` with a leading
layer axis, ``models/convert.reference_key``) and the stack entries are
dropped from the result.

The design mapping:

=============================  =========================================
reference                      port
=============================  =========================================
``PartitionSpec``              ``placements(spec, mesh)``: an axis name
                               is ``Shard(dim)`` on that mesh dim; an
                               absent axis is ``Replicate()``
``device_put(x, sharding)``    ``distribute(x, spec, sharder)``: each
                               rank keeps its slice (``distribute_tensor``
                               without a source rank)
``with_sharding_constraint``   ``DTensor.redistribute`` (``Sharder``)
``shard_map`` island (MoE,     ``island``: ``redistribute`` +
CP)                            ``to_local``, the body on local tensors
                               with functional collectives, then
                               ``DTensor.from_local``
``lax.axis_index(ax)``         ``Sharder.index(ax)``: the rank's
                               coordinate on that mesh dim
``psum`` / ``pmean``           ``psum`` / ``pmean``: all-reduce sum /
                               average over that dim's group
=============================  =========================================

An island's gradients follow shard_map's: an input sharded on a mesh axis
gets its own slice's gradient; an input replicated on an axis along which
the body varies (some input is sharded there) gets a partial gradient,
summed by DTensor on the way out; elsewhere the gradient is replicated.
``psum`` returns a value every rank of the group holds alike, so its
backward passes the (alike) gradient through; ``pmean`` scales it.

Without a mesh every ``Sharder`` method is the identity.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import torch

TP = "model"
FSDP = "data"

#: a spec: per tensor dim None, an axis name, or a tuple of axis names
Spec = tuple


def _P(*entries) -> Spec:
    return tuple(entries)


def _rule(path: str, shape: tuple[int, ...]) -> Spec:
    """Spec for one param.  ``path`` is the '/'-joined key path of the
    reference's (stacked) leaf and ``shape`` its shape."""
    nd = len(shape)
    leaf = path.rsplit("/", 1)[-1]

    # --- embeddings & heads: (V, d) vocab-TP, d-FSDP
    if "table" in leaf or "embed" in path or "lm_head" in path:
        return _P(TP, FSDP) if nd == 2 else _P(None)
    if "meta_tokens" in path:
        return _P(None, None)

    # --- MoE expert stacks: (E, d, ff) / (E, ff, d) (+ optional layer dim)
    if any(k in path for k in ("moe/up", "moe/gate", "moe/down")):
        if nd == 3:
            return _P(TP, None, FSDP)
        if nd == 4:  # stacked: (L, E, ...)
            return _P(None, TP, None, FSDP)
    if "router" in path:
        return _P(*([None] * nd))

    # --- attention projections
    if leaf == "w":
        if any(k in path for k in ("wq", "wk", "wv", "in_up", "in_proj",
                                   "up", "gate", "wx")):
            # (d_in, big) -> TP on the wide output dim, FSDP on input dim
            if nd == 2:
                return _P(FSDP, TP)
            if nd == 3:  # stacked (L, d_in, big)
                return _P(None, FSDP, TP)
        if any(k in path for k in ("wo", "down", "out", "out_proj", "wuk",
                                   "wuv")):
            # (big, d_out) -> TP on input dim, FSDP on output dim
            if nd == 2:
                return _P(TP, FSDP)
            if nd == 3:
                return _P(None, TP, FSDP)
        if "wdkv" in path or "w_dt" in path or "wx_bc" in path or \
                "wx_dt" in path:
            if nd == 2:
                return _P(FSDP, None)
            if nd == 3:
                return _P(None, FSDP, None)
        if "rh" in path:  # (H, dh, 4dh) slstm recurrence
            return _P(*([None] * nd)) if nd < 3 else \
                _P(*([None] * (nd - 3)), TP, None, None)
        if "conv" in path:
            return _P(*([None] * nd))
        # fallback 2D: FSDP x TP
        if nd >= 2:
            return _P(*([None] * (nd - 2)), FSDP, TP)
    # --- norms, biases, gates, scalars: replicate
    return _P(*([None] * nd))


def _axes(entry) -> tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def _fit_to_mesh(spec: Spec, shape: tuple[int, ...], mesh) -> Spec:
    """Drop sharded axes whose mesh size does not divide the dim (odd vocab
    sizes like 49155, small head counts); keeps the rest of the spec.
    Reads only ``mesh.shape``."""
    if mesh is None:
        return spec
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        if entry is None:
            out.append(None)
            continue
        size = math.prod(mesh.shape[a] for a in _axes(entry))
        out.append(entry if dim % size == 0 else None)
    return tuple(out)


def leaf_spec(name: str, shape: Sequence[int], mesh=None) -> Spec:
    """The spec of the port's parameter ``name`` (a state-dict name) of
    ``shape``: the reference's rule and fit on the stacked leaf, the stack
    entries dropped."""
    from .convert import reference_key

    path, index = reference_key(name)
    stacked = (1,) * len(index) + tuple(shape)
    spec = _fit_to_mesh(_rule(path, stacked), stacked, mesh)
    return tuple(spec[len(index):])


def param_specs(params, mesh=None) -> dict[str, Spec]:
    """Spec of every parameter by state-dict name (divisibility checked
    when a mesh is given).  ``params``: a ``Params`` module or a mapping of
    names to tensors."""
    from .convert import named_tensors

    return {name: leaf_spec(name, tuple(t.shape), mesh)
            for name, t in named_tensors(params).items()}


# --------------------------------------------------------------------------
# specs as DTensor placements
# --------------------------------------------------------------------------
def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (one per mesh dim): an
    axis that shards tensor dim d is ``Shard(d)``, an absent axis
    ``Replicate()``.  A tuple entry shards one dim over several mesh dims,
    which must come in the mesh's order (DTensor splits major first)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.axis_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} shards two dims "
                                 f"in {spec}")
            out[i] = Shard(dim)
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """The rank's local piece of a DTensor (a view: writes land in it),
    or ``t`` itself."""
    return t.to_local() if is_dtensor(t) else t


def distribute(x: torch.Tensor, spec: Spec, sharder: "Sharder"):
    """``x`` (the same global tensor on every rank) as a DTensor of
    ``spec``: each rank keeps its own slice, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    if is_dtensor(x):
        return sharder(x, *spec)
    return distribute_tensor(x, sharder.dm, placements(spec, sharder.mesh),
                             src_data_rank=None)


def like(t: torch.Tensor, ref):
    """``t`` as a replicated DTensor on ``ref``'s mesh where ``ref`` is a
    DTensor and ``t`` is not (a mask, a rope table, a position range),
    else ``t``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(ref) or is_dtensor(t) or not isinstance(
            t, torch.Tensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def split_last(t: torch.Tensor, *dims: int) -> torch.Tensor:
    """``t`` with its last dim split into ``dims``.  A DTensor whose last
    dim is sharded over more ranks than ``dims[0]`` divides over is
    gathered along it first: DTensor does not unflatten an uneven shard
    (8 KV heads of a projection sharded 16 ways)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        last = t.ndim - 1
        on_last = [isinstance(p, Shard) and p.dim in (last, -1)
                   for p in t.placements]
        ranks = math.prod(t.device_mesh.size(i)
                          for i, on in enumerate(on_last) if on)
        if dims[0] % ranks:
            t = t.redistribute(t.device_mesh,
                               [Replicate() if on else p
                                for p, on in zip(t.placements, on_last)])
    return t.reshape(*t.shape[:-1], *dims)


class _GradInLayout(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as the input
    was laid out."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.device_mesh, tuple(x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, want = ctx.layout
        if is_dtensor(g) and tuple(g.placements) != want:
            g = g.redistribute(mesh, want)
        return g


def grad_in_layout(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient comes back in ``x``'s own layout: where a
    tensor has two uses (the tied embedding table: the lookup and the
    logits), DTensor must not add two gradients of different layouts
    (torch 2.11 cannot make a shard a partial sum)."""
    return _GradInLayout.apply(x) if is_dtensor(x) else x


class _MergeLast(torch.autograd.Function):
    """The last ``k`` dims merged; the backward splits the gradient with
    ``split_last``."""

    @staticmethod
    def forward(ctx, t, k):
        ctx.dims = tuple(t.shape[-k:])
        return t.reshape(*t.shape[:-k], -1)

    @staticmethod
    def backward(ctx, g):
        return split_last(g, *ctx.dims), None


def merge_last(t: torch.Tensor, k: int = 2) -> torch.Tensor:
    """``t`` with its last ``k`` dims merged into one (the heads back into
    the model width).  For a DTensor the backward gathers the gradient's
    last dim where its shard would split the heads unevenly."""
    if is_dtensor(t):
        return _MergeLast.apply(t, k)
    return t.reshape(*t.shape[:-k], -1)


def local_offset(x) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(local shape, global offset) of this rank's piece of DTensor
    ``x``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape, off = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return tuple(shape), tuple(off)


# --------------------------------------------------------------------------
# collectives inside islands
# --------------------------------------------------------------------------
def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    out = funcol.all_reduce(t, op, group)
    return funcol.wait_tensor(out) if hasattr(funcol, "wait_tensor") \
        else out


class _PSum(torch.autograd.Function):
    """All-reduce sum whose result every rank holds alike: the backward
    passes the (alike) gradient through."""

    @staticmethod
    def forward(ctx, t, group, scale):
        ctx.scale = scale
        out = _all_reduce(t.contiguous(), "sum", group)
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``'s ranks (a process group or ``(device mesh,
    mesh dim)``)."""
    return _PSum.apply(t, group, 1.0)


def pmean(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """Mean over ``group``'s ``size`` ranks."""
    return _PSum.apply(t, group, 1.0 / size)


def all_reduce_nograd(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """A plain all-reduce (``"sum"`` or ``"max"``) for code that takes no
    gradient (decode)."""
    return _all_reduce(t.contiguous(), op, group)


# --------------------------------------------------------------------------
# the activation-constraint helper
# --------------------------------------------------------------------------
class Sharder:
    """Activation-constraint helper; identity when no mesh is given.

    ``mesh`` is a ``launch.mesh.Mesh``; its DeviceMesh (``dm``) is built on
    first use, on ``device``'s backend."""

    def __init__(self, mesh=None, dp=("data",), tp: str = TP,
                 pod_in_dp: bool = True, device=None):
        self.mesh = mesh
        if mesh is not None and pod_in_dp and "pod" in mesh.axis_names:
            dp = ("pod",) + tuple(a for a in dp if a != "pod")
        self.dp = tuple(dp)
        self.tp = tp
        self.device = device

    @property
    def dm(self):
        return self.mesh.device_mesh(self.device)

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        out = 1
        for a in self.dp:
            out *= self.mesh.shape[a]
        return out

    @property
    def tp_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[self.tp]

    def index(self, axis: str) -> int:
        """This rank's coordinate on mesh axis ``axis``."""
        return self.dm.get_local_rank(axis)

    def group(self, axis: str):
        """``(device mesh, mesh dim)``: the functional collectives' group
        of this rank's ranks along ``axis``."""
        return (self.dm, self.mesh.axis_names.index(axis))

    def __call__(self, x, *spec):
        if self.mesh is None:
            return x
        spec = tuple(spec) + (None,) * (x.ndim - len(spec))
        if not is_dtensor(x):
            return distribute(x, spec, self)
        want = placements(spec, self.mesh)
        if list(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)

    def batch(self, x):
        """Shard dim 0 over dp axes (if divisible), rest replicated."""
        if self.mesh is None:
            return x
        if x.shape[0] % self.dp_size == 0:
            return self(x, self.dp, *([None] * (x.ndim - 1)))
        # a plain tensor still becomes a (replicated) DTensor
        return x if is_dtensor(x) else self(x, *([None] * x.ndim))

    sp = True  # sequence-parallel residual stream (Megatron-SP layout)

    def acts(self, x):
        """(B, S, d) activations between blocks: batch over dp; with SP the
        sequence axis is additionally sharded over tp."""
        if self.mesh is None:
            return x
        b_ok = x.shape[0] % self.dp_size == 0 and x.shape[0] > 1
        s_ok = (self.sp and x.ndim >= 3 and
                x.shape[1] % self.mesh.shape[self.tp] == 0 and x.shape[1] > 1)
        if not b_ok and not s_ok:
            return x
        return self(x, self.dp if b_ok else None,
                    self.tp if s_ok else None, *([None] * (x.ndim - 2)))

    def heads(self, x):
        """(B, S, H, dh): batch over dp, heads over tp."""
        if self.mesh is None:
            return x
        return self(x, *self.heads_spec(x.shape))

    def heads_spec(self, shape) -> Spec:
        b_ok = shape[0] % self.dp_size == 0
        h_ok = shape[2] % self.mesh.shape[self.tp] == 0
        return (self.dp if b_ok else None, None, self.tp if h_ok else None,
                None)

    def kv_cache_spec(self, shape, batch_axis: int = 1, seq_axis: int = 2,
                      head_axis: int | None = 3) -> Spec:
        """Spec for a stacked cache (L, B, Smax, KH, dh) [axes
        configurable]: batch over dp if divisible, else sequence over dp
        (long-context decode); heads over tp when divisible, else the
        sequence axis takes tp too."""
        if self.mesh is None:
            return ()
        specs: list = [None] * len(shape)
        if shape[batch_axis] % self.dp_size == 0 and shape[batch_axis] > 1:
            specs[batch_axis] = self.dp
        elif shape[seq_axis] % self.dp_size == 0:
            specs[seq_axis] = self.dp
        tp_n = self.mesh.shape[self.tp]
        if head_axis is not None and shape[head_axis] % tp_n == 0:
            specs[head_axis] = self.tp
        elif specs[seq_axis] is None and shape[seq_axis] % tp_n == 0:
            specs[seq_axis] = self.tp
        elif specs[seq_axis] == self.dp and \
                shape[seq_axis] % (self.dp_size * tp_n) == 0:
            specs[seq_axis] = (*self.dp, self.tp)
        return tuple(specs)

    def kv_cache(self, x, batch_axis: int = 1, seq_axis: int = 2,
                 head_axis: int | None = 3):
        if self.mesh is None:
            return x
        spec = self.kv_cache_spec(x.shape, batch_axis, seq_axis, head_axis)
        return self(x, *spec)

    def logits(self, x):
        if self.mesh is None:
            return x
        b_ok = x.shape[0] % self.dp_size == 0
        v_ok = x.shape[-1] % self.mesh.shape[self.tp] == 0
        return self(x, self.dp if b_ok else None,
                    *([None] * (x.ndim - 2)), self.tp if v_ok else None)


# --------------------------------------------------------------------------
# islands: a body on each rank's local pieces (the reference's shard_map)
# --------------------------------------------------------------------------
def _spec_axes(spec: Spec) -> set:
    return {a for e in spec if e is not None for a in _axes(e)}


def enter(x, spec: Spec, sharder: Sharder, vary=()) -> torch.Tensor:
    """The rank's local piece of ``x`` laid out as ``spec``.  Its gradient
    is the slice's on the axes ``spec`` shards, partial on the other axes
    in ``vary`` (the body differs along them), replicated elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = sharder.mesh
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    x = sharder(x, *spec)
    grads = [p if isinstance(p, Shard) else
             (Partial() if name in vary else Replicate())
             for name, p in zip(mesh.axis_names, placements(spec, mesh))]
    return x.to_local(grad_placements=grads)


def leave(t: torch.Tensor, spec: Spec, sharder: Sharder):
    """The local pieces ``t`` as one DTensor laid out as ``spec`` (every
    rank's piece the same shape)."""
    from torch.distributed.tensor import DTensor

    mesh = sharder.mesh
    spec = tuple(spec) + (None,) * (t.ndim - len(spec))
    shape = [n * math.prod(mesh.shape[a] for a in _axes(e))
             if e is not None else n for n, e in zip(t.shape, spec)]
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t, sharder.dm, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def island(sharder: Sharder, fn: Callable, args: Sequence, in_specs,
           out_specs) -> Any:
    """``fn`` on each rank's local pieces of ``args`` (laid out by
    ``in_specs``; a ``None`` spec passes the argument through), its
    outputs (a tensor or a tuple, laid out by ``out_specs``) put back
    together as DTensors.  The body varies along every axis that some
    input spec shards."""
    vary = set()
    for spec in in_specs:
        if spec is not None:
            vary |= _spec_axes(spec)
    local = [a if spec is None else enter(a, spec, sharder, vary)
             for a, spec in zip(args, in_specs)]
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(leave(o, s, sharder) for o, s in zip(out, out_specs))
    return leave(out, out_specs, sharder)
