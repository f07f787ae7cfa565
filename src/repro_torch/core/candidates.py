"""The planner's candidate vocabulary: a backend plus its knobs, and which
problems each backend can transform on Hopper.

The backend keys are the reference package's (``xla``,
``stockham_pallas``, ...), and :meth:`Candidate.key` renders the same plan
keys, so a plan the reference or a wisdom record selected runs the same
schedule here (:meth:`Candidate.from_key`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

from .client import Problem
from .extents import _factors_only

_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*)(?:\((.*)\))?$")


@dataclass(frozen=True)
class Candidate:
    """One point in the planner's search space: a backend applied to every
    axis, with its knobs (``options``, in key order)."""

    backend: str
    options: tuple[tuple[str, Any], ...] = ()

    def opts(self) -> dict[str, Any]:
        return dict(self.options)

    def key(self) -> str:
        o = ",".join(f"{k}={v}" for k, v in self.options)
        return f"{self.backend}({o})" if o else self.backend

    @classmethod
    def from_key(cls, key: str) -> "Candidate":
        """Parse a plan key such as ``stockham_pallas(radix=4,tile_b=16)``.
        Integer knob values come back as ints.  Per-axis (``nd[...]``) and
        mesh (``slab[4]``) keys belong to later slices and raise."""
        m = _KEY.match(key.strip())
        if m is None:
            raise ValueError(f"unsupported plan key {key!r} (homogeneous "
                             "'backend(k=v,...)' keys only)")
        backend, body = m.group(1), m.group(2)
        options = []
        for item in filter(None, (body or "").split(",")):
            k, sep, v = item.partition("=")
            if not sep or not k:
                raise ValueError(f"bad knob {item!r} in plan key {key!r}")
            options.append((k, int(v) if re.fullmatch(r"-?\d+", v) else v))
        return cls(backend, tuple(options))


def _smooth7(n: int) -> bool:
    return n >= 1 and _factors_only(n, (2, 3, 5, 7))


def _torch_dtype(precision: str):
    import torch
    return torch.complex64 if precision == "float" else torch.complex128


def stockham_max_n(precision: str) -> int:
    """Longest axis the Stockham kernel holds in one block's shared memory."""
    from ..kernels.stockham_pallas.ops import MAX_N
    return MAX_N[_torch_dtype(precision)]


def axis_feasible(backend: str, n: int, precision: str = "float") -> bool:
    """Can ``backend`` transform one batched axis of engine length ``n``
    (see :func:`axis_engine_n`) on Hopper?  Whole-transform backends other
    than ``xla`` have no per-axis form."""
    if backend == "xla":
        return True
    if backend == "stockham_pallas":
        return _smooth7(n) and n <= stockham_max_n(precision)
    if backend == "fourstep_pallas":
        from ..kernels.fft4step.ops import feasible
        return feasible(n, _torch_dtype(precision))
    return False


def axis_engine_n(problem: Problem, axis: int) -> int:
    """Extent the 1-D engine actually transforms along ``axis``: real kinds
    take the packed half-length path on the innermost axis (n//2 for even
    n; odd lengths pay the full complex transform)."""
    n = problem.extents[axis]
    if problem.complex_input or axis < problem.rank - 1:
        return n
    return n // 2 if n % 2 == 0 and n > 1 else n


def fft2_feasible(problem: Problem) -> bool:
    """The fused rank-2 kernel holds the whole n1 x n2 engine tile (the
    packed n1 x n2/2 one for a real kind) in one block's shared memory;
    real kinds need an even last extent."""
    from ..kernels.fft2_pallas.ops import MAX_ELEMS, pow2
    exts = problem.extents
    if len(exts) != 2 or not all(pow2(v) for v in exts):
        return False
    if not (problem.complex_input or exts[-1] % 2 == 0):
        return False
    tile = exts[0] * axis_engine_n(problem, 1)
    return tile <= MAX_ELEMS[_torch_dtype(problem.precision)]


def backend_supports(backend: str, problem: Problem) -> bool:
    """Can ``backend`` run ``problem`` on Hopper (the reference's rules,
    with the Hopper caps in place of the VMEM ones)?"""
    if backend == "fft2_pallas":
        return fft2_feasible(problem)
    if backend == "xla":
        return True
    return all(axis_feasible(backend, axis_engine_n(problem, i),
                             problem.precision)
               for i in range(problem.rank))
