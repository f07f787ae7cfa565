"""Per-device op counts of a traced step: the counterpart of the reference
package's ``roofline/hlo_parse.py``.

The reference compiles a step and parses the per-device HLO module: each
dot's flops and operand/output bytes, each collective's output bytes,
multiplied through while-loop trip counts (its scan over layers runs its
body once in ``cost_analysis``).  The port has no HLO to parse.  It runs
the step eagerly (on ``meta`` tensors over a fake process group in the dry
run) under :class:`OpCounter`, which sees every op as it happens, so every
layer and every microbatch is visited and there is no trip count to
recover.

What is counted, per device:

- products (``mm``, ``bmm``, ``addmm``, ``baddbmm``; einsum and matmul
  reach them): ``2 * M * N * K`` flops and the operands' and output's
  bytes.  For a DTensor product the local shapes are taken: the output's
  own piece, and the contraction split over the mesh dims where the output
  is a partial sum.  A replicated product is paid in full by every rank of
  its group, as it is on the devices.  (``FlopCounterMode`` over DTensors
  counts the global op instead.)
- collectives, by the reference's kinds (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``): each one's
  output bytes on this rank and its count, for DTensor's redistributions
  and the islands' own collectives alike (the functional collectives are
  wrapped while the counter is on); also the bytes by mesh axis, where
  the group is a ``(device mesh, mesh dim)`` pair (``by_axis``).

Elementwise flops are ignored, as in the reference.
"""

from __future__ import annotations

import contextlib
import math
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_aten = torch.ops.aten
#: product ops -> (lhs index, rhs index) among their arguments
_DOTS = {_aten.mm.default: (0, 1), _aten.bmm.default: (0, 1),
         _aten.addmm.default: (1, 2), _aten.baddbmm.default: (1, 2)}

#: functional-collective entry points (names vary across torch versions)
#: -> the reference's kind
_FUNCOL = {
    "all_gather_tensor": "all-gather", "all_gather_tensor_autograd":
    "all-gather", "all_gather_single": "all-gather",
    "all_gather_single_autograd": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_autograd": "reduce-scatter",
    "reduce_scatter_single": "reduce-scatter",
    "reduce_scatter_single_autograd": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_autograd": "all-reduce",
    "all_to_all_single": "all-to-all",
    "all_to_all_single_autograd": "all-to-all",
    "permute_tensor": "collective-permute",
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local(t):
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _axis(args, kwargs) -> str:
    """The mesh axis of a collective's group: a ``(device mesh, dim)``
    pair in its arguments (``group=``, or ``mesh, mesh_dim``), else
    ``"?"``."""
    from torch.distributed.device_mesh import DeviceMesh

    cands = list(args) + list(kwargs.values())
    for i, c in enumerate(cands):
        if isinstance(c, tuple) and len(c) == 2 and \
                isinstance(c[0], DeviceMesh):
            return c[0].mesh_dim_names[c[1]]
        if isinstance(c, DeviceMesh) and i + 1 < len(cands) and \
                isinstance(cands[i + 1], int):
            return c.mesh_dim_names[cands[i + 1]]
    return "?"


def _partial_split(out) -> int:
    """How many ways the contraction of a DTensor product is split: the
    product of the mesh sizes where the output is a partial sum."""
    from torch.distributed.tensor import DTensor, Partial
    if not isinstance(out, DTensor):
        return 1
    mesh = out.device_mesh
    return math.prod(mesh.size(i) for i, p in enumerate(out.placements)
                     if isinstance(p, Partial))


class OpCounter(TorchDispatchMode):
    """Counts products and collectives per device while active (a context
    manager).  ``summary()`` gives the reference's keys."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.dot_bytes = 0.0
        self.coll_bytes: dict[str, float] = defaultdict(float)
        self.coll_counts: dict[str, int] = defaultdict(int)
        self.by_axis: dict[str, dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        self._patches = contextlib.ExitStack()
        self._inner = 0

    # ---------------------------------------------------------- products
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _DOTS:
            self._dot(func, args, out)
        return out

    def _dot(self, func, args, out) -> None:
        li, ri = _DOTS[func]
        lhs, rhs = args[li], args[ri]
        lo = _local(out)
        k = lhs.shape[-1] // _partial_split(out)
        flops = 2.0 * lo.numel() * k
        m, n = lo.shape[-2], lo.shape[-1]
        batch = lo.numel() // max(m * n, 1)
        size = lo.element_size()
        self.dot_flops += flops
        self.dot_bytes += size * (batch * m * k + batch * k * n + lo.numel())

    # ------------------------------------------------------- collectives
    def _record(self, kind: str, out, args, kwargs) -> None:
        self.coll_bytes[kind] += _nbytes(out)
        self.coll_counts[kind] += 1
        self.by_axis[_axis(args, kwargs)][kind] += _nbytes(out)

    def _wrap(self, module, name: str, kind: str) -> None:
        fn = getattr(module, name, None)
        if fn is None:
            return

        def counted(*a, **kw):
            self._inner += 1
            try:
                out = fn(*a, **kw)
            finally:
                self._inner -= 1
            if not self._inner:
                self._record(kind, out, a, kw)
            return out
        setattr(module, name, counted)
        self._patches.callback(setattr, module, name, fn)

    def __enter__(self):
        from torch.distributed import _functional_collectives as funcol
        for name, kind in _FUNCOL.items():
            self._wrap(funcol, name, kind)
        try:
            from torch.distributed.tensor import placement_types
            self._wrap(placement_types, "shard_dim_alltoall", "all-to-all")
        except ImportError:
            pass
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._patches.close()

    def summary(self) -> dict:
        """The reference's ``analyze`` keys: ``dot_flops``, ``dot_bytes``,
        ``collective_bytes`` and ``collective_counts`` by kind,
        ``collective_total``; and ``collective_by_axis``."""
        by_kind = {k: float(self.coll_bytes.get(k, 0.0)) for k in KINDS}
        return {"dot_flops": float(self.dot_flops),
                "dot_bytes": float(self.dot_bytes),
                "collective_bytes": by_kind,
                "collective_counts": {k: int(self.coll_counts.get(k, 0))
                                      for k in KINDS},
                "collective_total": float(sum(by_kind.values())),
                "collective_by_axis": {a: dict(v) for a, v in
                                       sorted(self.by_axis.items())}}


def analyze(fn, *args, **kwargs) -> tuple[object, dict]:
    """``fn(*args, **kwargs)`` under an :class:`OpCounter`: (its result,
    the counts' summary)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.summary()
