"""Distributed FFTs over a rank mesh: the reference package's
``fft/distributed.py`` on ``torch.distributed`` (FFTW-MPI / cuFFTMp's
slab and pencil decompositions, and the four-step across the mesh).

Every rank runs the same program on its own block (SPMD): each
``make_*`` returns a callable on the rank's local block, together with
the in and out specs (one entry per global dimension: ``None``, an axis
name or a tuple of axis names), where the reference returns a jitted
``shard_map``.  :func:`shard` cuts a rank's block out of a global array
and :func:`unshard` gathers the blocks back.

1D (dist1d): n = n1*n2 viewed as an (n1, n2) matrix with rows sharded;
   one all_to_all before the column pass and one after it, the twiddle of
   the rank's columns in between (built once per rank and direction, when
   the transform is built).  The spectrum comes out in TRANSPOSED order
   (k = k1 + k2*n1, FFTW-MPI's ``FFTW_MPI_TRANSPOSED_OUT``), or in
   natural order for one more all_to_all.
ND slab / pencil: shard the leading axes, transform the local ones,
   all_to_all to rotate the next axis into locality, repeat.

The collective is :func:`all_to_all`, ``jax.lax.all_to_all(..., tiled=
True)``'s meaning on ``all_to_all_single``; it counts its calls and the
bytes each rank sends (``A2A_CALLS``, ``A2A_BYTES``), which the reference
reads from the compiled HLO instead.  At P = 1 it is still called: the
one-rank group's collective is the same code path as P > 1.

Local transforms run through per-axis engines ``cfft(x, inverse=False)``
on the last axis (the engine layer's contract, ``nd._apply_last``): the
planner's picks, bound to their tables, or the plain four-step baseline.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..launch.mesh import default_rank_device
from . import fourstep
from .nd import _apply_last

#: Calls of :func:`all_to_all` in this process, and the bytes of the blocks
#: this rank sent through them (its own chunk included).
A2A_CALLS = 0
A2A_BYTES = 0

#: Elements of the twiddle grid built per step (keeps the float64 angles of
#: a 2^26-point grid from being built whole).
TWIDDLE_CHUNK = 1 << 22


def reset_collective_counts() -> None:
    global A2A_CALLS, A2A_BYTES
    A2A_CALLS = A2A_BYTES = 0


def _axes(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _mesh_size(mesh, axis) -> int:
    return math.prod(mesh.shape[a] for a in _axes(axis))


def all_to_all(x: torch.Tensor, mesh, axes, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Tiled all_to_all over the mesh group of ``axes``: ``split_axis`` is
    cut into P chunks, chunk i goes to the group's i-th member (row-major
    over ``axes``), and the chunks received are concatenated along
    ``concat_axis`` in member order."""
    global A2A_CALLS, A2A_BYTES
    group, members = mesh.group(axes)
    p = len(members)
    split_axis, concat_axis = split_axis % x.ndim, concat_axis % x.ndim
    if x.shape[split_axis] % p:
        raise ValueError(f"all_to_all: {p} ranks do not divide axis "
                         f"{split_axis} of {tuple(x.shape)}")
    A2A_CALLS += 1
    A2A_BYTES += x.numel() * x.element_size()
    # chunks along a new leading axis; a view where P = 1
    send = x.unflatten(split_axis, (p, -1)).movedim(split_axis, 0)
    order = sorted(members)    # torch's group-rank order
    if order != list(members):
        send = send[[members.index(r) for r in order]]
    send = send.contiguous()
    wire = torch.view_as_real(send) if send.is_complex() else send
    recv = torch.empty_like(wire)
    dist.all_to_all_single(recv, wire, group=group)
    out = torch.view_as_complex(recv) if send.is_complex() else recv
    if order != list(members):
        out = out[[order.index(r) for r in members]]
    return out.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


def _engines_for(rank: int, engines) -> tuple:
    """One local engine per global axis (default: the plain four-step
    baseline)."""
    if engines is None:
        return (fourstep.fft,) * rank
    if callable(engines):
        return (engines,) * rank
    fns = tuple(engines)
    if len(fns) != rank:
        raise ValueError(f"{len(fns)} local engines for rank {rank}")
    return fns


def _entry_ranks(mesh, entry) -> int:
    """The ranks a spec entry (None, an axis name or a tuple of them)
    shards its dimension over."""
    return 1 if entry is None else _mesh_size(mesh, entry)


def block_shape(shape, mesh, spec) -> tuple[int, ...]:
    """A rank's block of a global array of ``shape`` under ``spec``."""
    return tuple(d // _entry_ranks(mesh, e) for d, e in zip(shape, spec))


def _block_index(mesh, spec, shape, rank: int) -> tuple[slice, ...]:
    out = []
    for d, entry in enumerate(spec):
        p = _entry_ranks(mesh, entry)
        if shape[d] % p:
            raise ValueError(f"{p} ranks do not divide dimension {d} of "
                             f"{tuple(shape)}")
        if entry is None:
            out.append(slice(None))
            continue
        b = shape[d] // p
        i = mesh.index(entry, rank)
        out.append(slice(i * b, (i + 1) * b))
    return tuple(out)


def shard(x, mesh, spec, rank: int | None = None):
    """The block of the global array ``x`` (numpy or torch) that ``rank``
    (default: this process's) holds under ``spec``; a view."""
    rank = (dist.get_rank() if dist.is_initialized() else 0) \
        if rank is None else rank
    return x[_block_index(mesh, spec, tuple(x.shape), rank)]


def unshard(block: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The global array whose blocks under ``spec`` the ranks hold: every
    rank gathers every block (a collective where P > 1)."""
    shape = [b * _entry_ranks(mesh, e) for b, e in zip(block.shape, spec)]
    if mesh.size == 1:
        return block
    wire = torch.view_as_real(block.contiguous()) if block.is_complex() \
        else block.contiguous()
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire)
    out = torch.empty(shape, dtype=block.dtype, device=block.device)
    for r, part in enumerate(parts):
        part = torch.view_as_complex(part) if block.is_complex() else part
        out[_block_index(mesh, spec, shape, r)] = part
    return out


# ---------------------------------------------------------------------------
# 1D: distributed four-step
# ---------------------------------------------------------------------------
def twiddle_grid(k1: np.ndarray, j2: np.ndarray, sign: float, n: int,
                 dtype: torch.dtype, device) -> torch.Tensor:
    """exp(i * sign*pi/n * k1*j2) on the (len(k1), len(j2)) grid: the
    reference's integer product, float64 angles and one cast, built a few
    rows at a time."""
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=device)
    j2 = torch.as_tensor(j2, dtype=torch.int64, device=device)
    out = torch.empty((k1.numel(), j2.numel()), dtype=dtype, device=device)
    rows = max(1, TWIDDLE_CHUNK // max(1, j2.numel()))
    scale = sign * math.pi / n
    for r in range(0, k1.numel(), rows):
        ang = (k1[r:r + rows, None] * j2[None, :]).to(torch.float64) * scale
        out[r:r + rows] = torch.polar(torch.ones_like(ang), ang).to(dtype)
    return out


def fft1d_twiddles(n1: int, n2: int, p: int, idx: int, inverse: bool,
                   dtype: torch.dtype, device) -> torch.Tensor:
    """The twiddle block of the rank at position ``idx``: (n1, n2/P) over
    its columns for the forward (:func:`fft1d_shard`), (n1/P, n2) over its
    k1 rows for the inverse (:func:`ifft1d_shard`)."""
    n = n1 * n2
    if inverse:
        k1 = idx * (n1 // p) + np.arange(n1 // p)
        return twiddle_grid(k1, np.arange(n2), 2.0, n, dtype, device)
    j2 = idx * (n2 // p) + np.arange(n2 // p)
    return twiddle_grid(np.arange(n1), j2, -2.0, n, dtype, device)


def fft1d_shard(x_block: torch.Tensor, n1: int, n2: int, mesh, axes,
                inverse: bool = False, engines=None,
                twiddles: torch.Tensor | None = None) -> torch.Tensor:
    """Per-rank body: ``x_block`` (n1/P, n2) holds rows of the (n1, n2)
    four-step matrix, row-sharded over ``axes``.  Returns (n1/P, n2): the
    rank's k1 slab of D[k1, k2], so flattening rank-major gives the
    transposed spectrum X[k1 + k2*n1].  The two passes apply 1/n1 and 1/n2
    in the inverse, so 1/n comes out exactly."""
    axes = _axes(axes)
    p = _mesh_size(mesh, axes)
    eng1, eng2 = _engines_for(2, engines)
    if twiddles is None:
        twiddles = fft1d_twiddles(n1, n2, p, mesh.index(axes), inverse,
                                  x_block.dtype, x_block.device)
    xt = all_to_all(x_block, mesh, axes, 1, 0)           # (n1, n2/P)
    xt = _apply_last(xt, 0, functools.partial(eng1, inverse=inverse))
    xt = xt * twiddles
    xb = all_to_all(xt, mesh, axes, 0, 1)                # (n1/P, n2)
    return eng2(xb.contiguous(), inverse=inverse)


def _choose_1d_factors(n: int, p: int) -> tuple[int, int]:
    """n = n1*n2 with p | n1 and p | n2 (every all_to_all of the pipeline,
    the natural-order one included, splits one of the two over the p
    ranks), as square as possible; ties keep the smaller n1.  The
    reference's search, over the divisors of n only."""
    best = None
    divisors = set()
    for d in range(1, math.isqrt(n) + 1):
        if n % d == 0:
            divisors.update((d, n // d))
    for n1 in sorted(divisors):
        n2 = n // n1
        if n1 % p == 0 and n2 % p == 0:
            score = abs(n1 - n2)
            if best is None or score < best[0]:
                best = (score, n1, n2)
    if best is None:
        raise ValueError(f"cannot shard n={n} over {p} devices")
    return best[1], best[2]


def can_shard_1d(n: int, p: int) -> bool:
    """Does an (n1, n2) factorization with p | n1 and p | n2 exist?"""
    try:
        _choose_1d_factors(n, p)
        return True
    except ValueError:
        return False


class Transform1D:
    """A built distributed 1-D transform of one rank: call it on the
    rank's (n/P,) block.  ``plan_bytes`` counts its twiddle block."""

    def __init__(self, body, twiddles: torch.Tensor):
        self._body = body
        self.twiddles = twiddles
        self.plan_bytes = twiddles.numel() * twiddles.element_size()

    def __call__(self, xb: torch.Tensor) -> torch.Tensor:
        if xb.dtype != self.twiddles.dtype:
            raise ValueError(f"transform built for {self.twiddles.dtype}, "
                             f"got {xb.dtype}")
        return self._body(xb)


def make_fft1d(mesh, axis, n: int, inverse: bool = False,
               natural: bool = False, engines=None, *,
               dtype: torch.dtype = torch.complex64, device=None):
    """A distributed 1-D FFT over ``mesh[axis]``: input (n,) complex
    sharded contiguously over ``axis``, output the spectrum with the same
    sharding, in transposed order by default or in natural order
    (``natural=True``, one more all_to_all).  ``engines`` are the local
    engines of the n1 and n2 passes.  Returns ``(fn, (n1, n2))``; ``fn``
    holds the rank's twiddles for ``dtype`` on ``device`` (default: this
    rank's card; raises without one)."""
    axes = _axes(axis)
    p = _mesh_size(mesh, axes)
    n1, n2 = _choose_1d_factors(n, p)
    tw = fft1d_twiddles(n1, n2, p, mesh.index(axes), inverse, dtype,
                        default_rank_device(device))

    def body(xb):
        blk = xb.reshape(n1 // p, n2)
        out = fft1d_shard(blk, n1, n2, mesh, axes, inverse=inverse,
                          engines=engines, twiddles=tw)  # (n1/P, n2)
        if natural:
            # D[k1, k2] -> Y[k2, k1]: flattened rank-major, this is
            # X[k1 + k2*n1] in natural order
            out = all_to_all(out, mesh, axes, 1, 0)      # (n1, n2/P)
            out = out.T
        return out.reshape(-1)

    return Transform1D(body, tw), (n1, n2)


def transposed_to_natural(y, n1: int, n2: int):
    """Undo the transposed spectrum order (host-side / test helper)."""
    return y.reshape(n1, n2).T.reshape(-1)


def ifft1d_shard(y_block: torch.Tensor, n1: int, n2: int, mesh, axes,
                 engines=None, twiddles: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Inverse per-rank body on the TRANSPOSED spectrum of
    :func:`fft1d_shard`: ``y_block`` (n1/P, n2) is the rank's k1 slab of
    Y[k1, k2] = X[k1 + k2*n1]; returns (n1/P, n2) rows of the natural
    signal x[j1*n2 + j2].  Row IDFTs (over k2, local), twiddle, transpose,
    column IDFTs (over k1), transpose back: two all_to_alls, as the
    forward."""
    axes = _axes(axes)
    p = _mesh_size(mesh, axes)
    eng1, eng2 = _engines_for(2, engines)
    if twiddles is None:
        twiddles = fft1d_twiddles(n1, n2, p, mesh.index(axes), True,
                                  y_block.dtype, y_block.device)
    b = eng2(y_block.contiguous(), inverse=True)         # (n1/P, n2)
    b = b * twiddles
    bt = all_to_all(b, mesh, axes, 1, 0)                 # (n1, n2/P)
    bt = _apply_last(bt, 0, functools.partial(eng1, inverse=True))
    return all_to_all(bt, mesh, axes, 0, 1)              # (n1/P, n2)


def make_ifft1d(mesh, axis, n: int, natural: bool = False, engines=None, *,
                dtype: torch.dtype = torch.complex64, device=None):
    """The inverse of :func:`make_fft1d`'s transform: input the (n,)
    spectrum sharded as ``make_fft1d`` emitted it (transposed order, or
    natural with ``natural=True``), output the natural-order signal with
    the same sharding.  Returns ``(fn, (n1, n2))``; ``device`` as
    :func:`make_fft1d`'s."""
    axes = _axes(axis)
    p = _mesh_size(mesh, axes)
    n1, n2 = _choose_1d_factors(n, p)
    tw = fft1d_twiddles(n1, n2, p, mesh.index(axes), True, dtype,
                        default_rank_device(device))

    def body(yb):
        if natural:
            # mirror the forward's untranspose: natural block (n2/P, n1)
            # -> local transpose -> all_to_all back to (n1/P, n2)
            blk = yb.reshape(n2 // p, n1).T                  # (n1, n2/P)
            blk = all_to_all(blk, mesh, axes, 0, 1)          # (n1/P, n2)
        else:
            blk = yb.reshape(n1 // p, n2)
        out = ifft1d_shard(blk, n1, n2, mesh, axes, engines=engines,
                           twiddles=tw)
        return out.reshape(-1)

    return Transform1D(body, tw), (n1, n2)


# ---------------------------------------------------------------------------
# ND planned decompositions: slab (1-D mesh) and pencil (2-D mesh)
# ---------------------------------------------------------------------------
# Both take blocks of (batch, *shape): the leading batch dimension is
# always there and never sharded.  The output is TRANSPOSED-sharded by
# default; ``natural=True`` pays the all_to_alls that restore the input's
# sharding.

def slab_divisible(shape: Sequence[int], p: int) -> bool:
    """Slab feasibility: p | d0 (input sharding) and p | d1 (the
    transpose splits d1 over the mesh)."""
    shape = tuple(shape)
    return (len(shape) >= 2 and p >= 1
            and shape[0] % p == 0 and shape[1] % p == 0)


def pencil_divisible(shape: Sequence[int], pr: int, pc: int) -> bool:
    """Pencil feasibility over a (pr, pc) mesh for a rank-3 transform:
    pr | X, pc | Y (input sharding); pc | Z (first rotation); pr | Y
    (second rotation)."""
    shape = tuple(shape)
    if len(shape) != 3:
        return False
    X, Y, Z = shape
    return X % pr == 0 and Y % pc == 0 and Z % pc == 0 and Y % pr == 0


def _entry(axis):
    return axis if isinstance(axis, str) else tuple(axis)


def make_slab_fftnd(mesh, axis, shape: Sequence[int], *,
                    inverse: bool = False, natural: bool = False,
                    engines=None):
    """A slab-decomposed ND FFT (rank 2 or 3, 1-D mesh) of blocks of
    (batch, d0, d1[, d2]) with d0 sharded over ``axis``: the inner axes
    transform locally, one all_to_all rotates d0 into locality (splitting
    d1).  Output d1-sharded (transposed) by default, or d0-sharded for one
    more all_to_all with ``natural=True``; ``inverse`` consumes the layout
    the forward with the same ``natural`` emitted and returns the natural
    d0-sharded signal.  Returns ``(fn, in_spec, out_spec)``."""
    shape = tuple(int(d) for d in shape)
    rank = len(shape)
    if rank not in (2, 3):
        raise ValueError(f"slab decomposition is rank-2/3 only, got {shape}")
    ax = _entry(axis)
    p = _mesh_size(mesh, axis)
    if not slab_divisible(shape, p):
        raise ValueError(f"slab: {p} devices must divide d0={shape[0]} "
                         f"and d1={shape[1]}")
    engs = _engines_for(rank, engines)
    tail = (None,) * (rank - 1)
    slab_spec = (None, ax, *tail)                       # d0 sharded
    trans_spec = (None, None, ax, *tail[1:])            # d1 sharded

    def run(x, block_ax, g):
        return _apply_last(x, block_ax,
                           functools.partial(engs[g], inverse=inverse))

    if not inverse or natural:
        # the forward pipeline; also the natural-in inverse, the transform
        # being separable (no cross-axis twiddle)
        def body(xb):                                   # (B, d0/P, d1[, d2])
            for g in range(rank - 1, 0, -1):            # inner axes, local
                xb = run(xb, g + 1, g)
            xb = all_to_all(xb, mesh, ax, 2, 1)         # (B, d0, d1/P[, d2])
            xb = run(xb, 1, 0)                          # d0, now local
            if natural:
                xb = all_to_all(xb, mesh, ax, 1, 2)
            return xb

        in_spec = slab_spec
        out_spec = slab_spec if natural else trans_spec
    else:
        # TRANSPOSED-in inverse: the forward mirrored, ending natural
        def body(yb):                                   # (B, d0, d1/P[, d2])
            yb = run(yb, 1, 0)                          # d0, local
            yb = all_to_all(yb, mesh, ax, 1, 2)         # (B, d0/P, d1[, d2])
            for g in range(1, rank):                    # inner axes, local
                yb = run(yb, g + 1, g)
            return yb

        in_spec = trans_spec
        out_spec = slab_spec
    return body, in_spec, out_spec


def make_pencil_fftnd(mesh, row_axis, col_axis, shape: Sequence[int], *,
                      inverse: bool = False, natural: bool = False,
                      engines=None):
    """A pencil-decomposed 3-D FFT over a (Pr, Pc) mesh of blocks of
    (batch, X, Y, Z) with X sharded over ``row_axis`` and Y over
    ``col_axis``: Z transforms locally, each other axis is rotated into
    locality by one all_to_all.  Output (X, Y/Pr, Z/Pc)-sharded
    (transposed) by default, or the input's layout for two more
    all_to_alls with ``natural=True``; ``inverse`` consumes the layout the
    matching forward emitted.  Returns ``(fn, in_spec, out_spec)``."""
    shape = tuple(int(d) for d in shape)
    if len(shape) != 3:
        raise ValueError(f"pencil decomposition is rank-3 only, got {shape}")
    row, col = _entry(row_axis), _entry(col_axis)
    pr, pc = _mesh_size(mesh, row_axis), _mesh_size(mesh, col_axis)
    if not pencil_divisible(shape, pr, pc):
        raise ValueError(f"pencil: mesh ({pr}x{pc}) incompatible with "
                         f"shape {shape} (need pr|X, pc|Y, pc|Z, pr|Y)")
    engs = _engines_for(3, engines)
    pencil_spec = (None, row, col, None)                # (B, X/Pr, Y/Pc, Z)
    trans_spec = (None, None, row, col)                 # (B, X, Y/Pr, Z/Pc)

    def run(x, block_ax, g):
        return _apply_last(x, block_ax,
                           functools.partial(engs[g], inverse=inverse))

    if not inverse or natural:
        def body(xb):                                   # (B, X/Pr, Y/Pc, Z)
            xb = run(xb, 3, 2)                          # Z, local
            xb = all_to_all(xb, mesh, col, 3, 2)        # (B, X/Pr, Y, Z/Pc)
            xb = run(xb, 2, 1)                          # Y, local
            xb = all_to_all(xb, mesh, row, 2, 1)        # (B, X, Y/Pr, Z/Pc)
            xb = run(xb, 1, 0)                          # X, local
            if natural:
                xb = all_to_all(xb, mesh, row, 1, 2)
                xb = all_to_all(xb, mesh, col, 2, 3)
            return xb

        in_spec = pencil_spec
        out_spec = pencil_spec if natural else trans_spec
    else:
        def body(yb):                                   # (B, X, Y/Pr, Z/Pc)
            yb = run(yb, 1, 0)                          # X, local
            yb = all_to_all(yb, mesh, row, 1, 2)        # (B, X/Pr, Y, Z/Pc)
            yb = run(yb, 2, 1)                          # Y, local
            yb = all_to_all(yb, mesh, col, 2, 3)        # (B, X/Pr, Y/Pc, Z)
            yb = run(yb, 3, 2)                          # Z, local
            return yb

        in_spec = trans_spec
        out_spec = pencil_spec
    return body, in_spec, out_spec


# ---------------------------------------------------------------------------
# 3D pencil on the plain four-step engine
# ---------------------------------------------------------------------------
def fft3d_shard(x_block: torch.Tensor, mesh, row_axis, col_axis,
                inverse: bool = False) -> torch.Tensor:
    """Per-rank pencil 3-D FFT of the (X/Pr, Y/Pc, Z) block (X sharded
    over ``row_axis``, Y over ``col_axis``) on the plain four-step engine;
    returns the spectrum's block in the same layout."""
    eng = functools.partial(fourstep.fft, inverse=inverse)
    x = eng(x_block.contiguous())                       # Z, local
    x = all_to_all(x, mesh, col_axis, 2, 1)             # (X/Pr, Y, Z/Pc)
    x = _apply_last(x, 1, eng)                          # Y
    x = all_to_all(x, mesh, row_axis, 1, 0)             # (X, Y/Pr, Z/Pc)
    x = _apply_last(x, 0, eng)                          # X
    # restore (X/Pr, Y/Pc, Z): undo both rotations
    x = all_to_all(x, mesh, row_axis, 0, 1)
    return all_to_all(x, mesh, col_axis, 1, 2)


def make_fft3d(mesh, row_axis, col_axis, shape: Sequence[int],
               inverse: bool = False, keep_transposed: bool = False):
    """A pencil 3-D FFT of (X, Y, Z) blocks sharded (row_axis, col_axis,
    None).  ``keep_transposed`` skips the restoring rotations (output
    sharded (None, row_axis, col_axis)), the cheaper layout when a round
    trip follows.  Returns ``(fn, in_spec, out_spec)``."""
    row, col = _entry(row_axis), _entry(col_axis)

    def body(xb):
        if not keep_transposed:
            return fft3d_shard(xb, mesh, row, col, inverse=inverse)
        eng = functools.partial(fourstep.fft, inverse=inverse)
        x = eng(xb.contiguous())
        x = all_to_all(x, mesh, col, 2, 1)
        x = _apply_last(x, 1, eng)
        x = all_to_all(x, mesh, row, 1, 0)
        return _apply_last(x, 0, eng)

    in_spec = (row, col, None)
    out_spec = (None, row, col) if keep_transposed else in_spec
    return body, in_spec, out_spec
