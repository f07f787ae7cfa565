"""Public wrapper of the fused rank-2 kernel: per-axis schedules, one
shared twiddle pack (host float64), shared-memory sizing, launch,
normalization.

``fft2`` launches the CUDA kernel (``repro_torch/csrc/fft2.cu``) for a
tensor on the card and takes the plain version (``ref.apply2``) only for a
tensor on the CPU.  A tile over the one-block cap (up to the reference's
2^18 points) runs as passes through global memory on the Stockham
library's entries (``csrc/stockham.cu``): the rows' n2-point FFTs, then
the columns' n1-point FFTs on the column entry (``Passes2``).
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..stockham_pallas import ops as sp
from ..stockham_pallas.ops import (SMEM_LIMIT_BYTES, direction_of, interleave,
                                   pack_twiddles, stage_bases)
from .fft2_pallas import SMEM_TARGET_BYTES, pow2, schedules, smem_bytes
from .ref import apply2

_CDTYPES = (torch.complex64, torch.complex128)

#: Kernel launches, and launches by (n1, n2, signals, dtype); the wrapper
#: adds to both where it launches the kernel and nowhere else.
LAUNCHES = 0
LAUNCH_SHAPES: Counter = Counter()


def _largest_pow2_fitting(itemsize: int) -> int:
    n = 1
    while 2 * (2 * n) * itemsize <= SMEM_LIMIT_BYTES:
        n *= 2
    return n


#: Largest n1*n2 one block holds (tile_b = 1, two buffers in shared
#: memory): 8192 points for complex64, 4096 for complex128.  Larger tiles
#: run as passes (``Passes2``); this cap is internal.
ONE_BLOCK_ELEMS = {torch.complex64: _largest_pow2_fitting(8),
                   torch.complex128: _largest_pow2_fitting(16)}

#: Largest n1*n2 the kernel takes: the reference's 2^18, in both dtypes.
MAX_ELEMS = {torch.complex64: 1 << 18, torch.complex128: 1 << 18}


def check_shape(n1: int, n2: int, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` for a tile the kernel cannot take."""
    if not (pow2(n1) and pow2(n2)):
        raise ValueError(
            f"fft2_pallas requires power-of-two extents, got {n1}x{n2}")
    if n1 * n2 > MAX_ELEMS[dtype]:
        raise ValueError(f"fft2_pallas caps at n1*n2={MAX_ELEMS[dtype]} for "
                         f"{dtype}, as the reference does; got {n1}x{n2}")


def pack_twiddles2(n1: int, n2: int, radices1, radices2, inverse: bool,
                   real_dtype):
    """Both axes' stage twiddles in one (1, L) pair, in the reference
    package's layout: the n2 (row) pack first, then the n1 (column) pack
    with its offsets shifted past it.  Each per-axis pack is the rank-1
    kernel's ``pack_twiddles``."""
    twr2, twi2, off2 = pack_twiddles(n2, radices2, inverse, real_dtype)
    twr1, twi1, off1 = pack_twiddles(n1, radices1, inverse, real_dtype)
    shift = twr2.shape[1]
    off1 = tuple(tuple(o + shift for o in stage) for stage in off1)
    twr = np.concatenate([twr2, twr1], axis=1)
    twi = np.concatenate([twi2, twi1], axis=1)
    return twr, twi, off1, off2


@dataclass(frozen=True)
class Twiddles2:
    """A plan's device state: both axes' schedules and their packed
    twiddles as one interleaved complex vector (``pack_twiddles2``'s layout,
    padding kept, so the bases are the reference's offsets).  ``inverse``
    is None when every twiddle is 1."""

    n1: int
    n2: int
    radices1: tuple[int, ...]
    radices2: tuple[int, ...]
    bases1: tuple[int, ...]
    bases2: tuple[int, ...]
    tw: torch.Tensor
    inverse: bool | None

    @property
    def nbytes(self) -> int:
        return self.tw.numel() * self.tw.element_size()


def _from_planes(twr: np.ndarray, twi: np.ndarray, off1, off2,
                 dtype: torch.dtype, device) -> Twiddles2:
    radices1 = tuple(len(o) + 1 for o in off1)
    radices2 = tuple(len(o) + 1 for o in off2)
    return Twiddles2(int(np.prod(radices1)), int(np.prod(radices2)),
                     radices1, radices2, stage_bases(off1), stage_bases(off2),
                     interleave(twr[0], twi[0], dtype, device),
                     direction_of(twi[0]))


@dataclass(frozen=True)
class Passes2:
    """A plan for a tile over the one-block cap: the Stockham kernel's
    plan of the row pass (n2-point FFTs along the rows) and of the column
    pass (n1-point FFTs down the columns, on the column entry), each one
    block's or two passes' (``stockham_pallas.ops.make_twiddles``); None
    for an extent of 1."""

    n1: int
    n2: int
    rows: "sp.Twiddles | sp.TwoPass | None"
    cols: "sp.Twiddles | sp.TwoPass | None"
    inverse: bool

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in (self.rows, self.cols) if p is not None)


def make_twiddles2(n1: int, n2: int, radix: int, inverse: bool,
                   dtype: torch.dtype, device) -> Twiddles2 | Passes2:
    """Build the plan of an n1 x n2 tile on ``device``: both schedules,
    twiddles in float64 on the host, cast once to ``dtype``'s precision and
    uploaded; one block's plan up to ``ONE_BLOCK_ELEMS``, else the
    passes'."""
    check_shape(n1, n2, dtype)
    if n1 * n2 > ONE_BLOCK_ELEMS[dtype]:
        axis = lambda n: sp.make_twiddles(n, radix, inverse, dtype, device) \
            if n > 1 else None
        return Passes2(n1, n2, axis(n2), axis(n1), inverse)
    radices1, radices2 = schedules(n1, n2, radix)
    real = np.float64 if dtype == torch.complex128 else np.float32
    return _from_planes(*pack_twiddles2(n1, n2, radices1, radices2, inverse,
                                        real), dtype, device)


def twiddles_from_reference(twr: np.ndarray, twi: np.ndarray, off1, off2,
                            device) -> Twiddles2:
    """The port's plan from the reference package's ``pack_twiddles2``
    output: same values, same offsets."""
    dtype = torch.complex128 if twr.dtype == np.float64 else torch.complex64
    return _from_planes(twr, twi, off1, off2, dtype, device)


def default_tile_b(n_elems: int, batch: int, itemsize: int,
                   n_stages: int) -> int:
    """Signals per block: as many as fill ``SMEM_TARGET_BYTES`` (at least
    one), never more than the batch."""
    per_sig = max(1, smem_bytes(n_elems, 1, itemsize, max(n_stages, 2)))
    return max(1, min(batch, SMEM_TARGET_BYTES // per_sig))


def fft2(x: torch.Tensor, inverse: bool = False, *, tile_b: int | None = None,
         radix: int = 8, twiddles: Twiddles2 | None = None) -> torch.Tensor:
    """Fused rank-2 FFT over the last two axes.

    Power-of-two extents with n1*n2 up to ``MAX_ELEMS[dtype]`` (2^18): one
    launch up to ``ONE_BLOCK_ELEMS[dtype]``, passes above it; numpy
    semantics (the inverse applies 1/(n1*n2)).  Real input is cast to
    complex64.  ``tile_b`` and ``radix`` are the tunable knobs;
    ``twiddles`` is a prebuilt plan (``make_twiddles2``) that must match
    the call's extents, schedules, dtype, device and direction.
    """
    if x.ndim < 2:
        raise ValueError(f"fft2 needs rank >= 2 input, got shape {tuple(x.shape)}")
    if not x.is_complex():
        x = x.to(torch.complex64)
    if x.dtype not in _CDTYPES:
        raise TypeError(f"fft2_pallas takes complex64/complex128, got {x.dtype}")
    n1, n2 = x.shape[-2], x.shape[-1]
    check_shape(n1, n2, x.dtype)
    if n1 * n2 == 1:
        return x   # the 1x1 DFT is the identity (its 1/n factor is 1 too)
    if twiddles is None:
        twiddles = make_twiddles2(n1, n2, radix, inverse, x.dtype, x.device)
    elif not _matches(twiddles, n1, n2, radix, inverse, x.dtype, x.device):
        raise ValueError("twiddles do not match this call: plan "
                         f"{twiddles.n1}x{twiddles.n2} ({type(twiddles).__name__}"
                         f", inverse={twiddles.inverse}); call {n1}x{n2} "
                         f"radix={radix} {x.dtype} on {x.device} "
                         f"inverse={inverse}")
    if x.device.type == "cpu":
        y = plain(x, twiddles, inverse)
        return y / (n1 * n2) if inverse else y
    if x.device.type != "cuda":
        raise ValueError(f"fft2_pallas runs on cuda or cpu, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("fft2_pallas needs a contiguous tensor (the two "
                         "transformed axes last, row-major)")
    return _launch(x, inverse, tile_b, twiddles)


def _matches(plan: Twiddles2 | Passes2, n1: int, n2: int, radix: int,
             inverse: bool, dtype: torch.dtype, device) -> bool:
    if (plan.n1, plan.n2) != (n1, n2):
        return False
    if isinstance(plan, Passes2):
        return n1 * n2 > ONE_BLOCK_ELEMS[dtype] and plan.inverse == inverse \
            and all(p is None if n == 1 else
                    sp._matches(p, n, radix, inverse, dtype, device)
                    for p, n in ((plan.rows, n2), (plan.cols, n1)))
    return (n1 * n2 <= ONE_BLOCK_ELEMS[dtype]
            and (plan.radices1, plan.radices2) == schedules(n1, n2, radix)
            and plan.tw.dtype == dtype and plan.tw.device == device
            and plan.inverse in (None, inverse))


def plain(x: torch.Tensor, plan: Twiddles2 | Passes2,
          inverse: bool) -> torch.Tensor:
    """The kernel's arithmetic under ``plan`` over the last two axes of
    complex ``x`` in plain torch, on any device; no 1/(n1*n2) scaling.
    Over one block: the row pass, then the column pass on the transposed
    view, each the Stockham kernel's plain version."""
    if isinstance(plan, Passes2):
        if plan.rows is not None:
            x = sp.plain(x, plan.rows, inverse)
        if plan.cols is not None:
            x = sp.plain(x.transpose(-1, -2), plan.cols,
                         inverse).transpose(-1, -2)
        return x
    return apply2(x, plan.tw, plan.radices1, plan.radices2, plan.bases1,
                  plan.bases2, inverse)


@functools.cache
def _kernel(dtype: torch.dtype):
    """The library's entry point for ``dtype``, its signature set once."""
    lib = _build.library("fft2")
    fn = lib.fft2_f64 if dtype == torch.complex128 else lib.fft2_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _c_ints(values: tuple[int, ...]):
    return (ctypes.c_int * len(values))(*values)


def _columns(src: torch.Tensor, dst: torch.Tensor, plan, sigs: int,
             n2: int, inverse: bool) -> int:
    """The n1-point FFTs down the n2 columns of each of ``sigs`` row-major
    n1 x n2 signals, on the Stockham library's column entry, into ``dst``
    in natural order (the inverse's 1/n1 folded in); returns the number of
    launches.  A column over the Stockham one-block cap (n1 = a*b) takes
    two: the a-point FFTs of the b*n2 columns (j_b, c), times
    W_n1^(k_a*j_b), then the b-point FFTs over j_b of each (k_a, c),
    stored at row k_a + a*k_b."""
    n1 = plan.n
    n = n1 * n2
    scale = 1.0 / n1 if inverse else 1.0
    if not isinstance(plan, sp.TwoPass):
        sp.column_pass(src, dst, plan, sigs, n2, in_sig=n, in_k=n2, out_k=n2,
                       out_col=1, out_big=n, inverse=inverse, scale=scale)
        return 1
    a, b = plan.n1, plan.n2
    tmp = torch.empty_like(src)
    sp.column_pass(src, tmp, plan.first, sigs, b * n2, in_sig=n,
                   in_k=b * n2, out_k=b * n2, out_col=1, out_big=n,
                   roots=plan.roots, tw_n=n1, tw_q=n2, inverse=inverse)
    sp.column_pass(tmp, dst, plan.second, sigs * a, n2, in_sig=b * n2,
                   in_k=n2, out_k=a * n2, out_col=1, out_big=n,
                   out_small=n2, group=a, inverse=inverse, scale=scale)
    return 2


def _run_passes(x: torch.Tensor, y: torch.Tensor, plan: Passes2,
                tile_b: int | None, inverse: bool) -> int:
    """The rows' pass (the Stockham kernel along the last axis: its 1/n2
    folded in), then the columns' (``_columns``: 1/n1), into ``y``;
    returns the number of launches."""
    if tile_b is not None:
        raise ValueError(f"tile_b={tile_b} does not fit one block for "
                         f"{plan.n1}x{plan.n2} {x.dtype}: the tile runs as "
                         "passes, which take no batch tile")
    sigs = x.numel() // (plan.n1 * plan.n2)
    if plan.cols is None:
        return sp.run_plan(x, y, plan.rows, inverse)
    launched, cur = 0, x
    if plan.rows is not None:
        cur = torch.empty_like(x)
        launched += sp.run_plan(x, cur, plan.rows, inverse)
    return launched + _columns(cur, y, plan.cols, sigs, plan.n2, inverse)


def _launch(x: torch.Tensor, inverse: bool, tile_b: int | None,
            twiddles: Twiddles2 | Passes2) -> torch.Tensor:
    global LAUNCHES
    n1, n2 = x.shape[-2], x.shape[-1]
    n = n1 * n2
    sigs = x.numel() // n
    y = torch.empty_like(x)
    if sigs == 0:
        return y
    if isinstance(twiddles, Passes2):
        launched = _run_passes(x, y, twiddles, tile_b, inverse)
    else:
        launched = _run_one_block(x, y, twiddles, tile_b, inverse)
    LAUNCHES += launched
    LAUNCH_SHAPES[(n1, n2, sigs, str(x.dtype).removeprefix("torch."))] \
        += launched
    return y


def _run_one_block(x: torch.Tensor, y: torch.Tensor, twiddles: Twiddles2,
                   tile_b: int | None, inverse: bool) -> int:
    n1, n2 = x.shape[-2], x.shape[-1]
    n = n1 * n2
    sigs = x.numel() // n
    itemsize = x.element_size()
    radices = twiddles.radices2 + twiddles.radices1
    n_stages = len(radices)
    tile = tile_b if tile_b is not None else default_tile_b(
        n, sigs, itemsize, n_stages)
    tile = min(tile, sigs)
    if tile < 1 or smem_bytes(n, tile, itemsize, n_stages) > SMEM_LIMIT_BYTES \
            or tile * n >= 1 << 30:
        raise ValueError(f"tile_b={tile_b} does not fit one block for "
                         f"{n1}x{n2} {x.dtype} (shared memory limit "
                         f"{SMEM_LIMIT_BYTES} bytes)")
    fn = _kernel(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), twiddles.tw.data_ptr(), sigs,
                 n1, n2, tile, int(inverse), n_stages,
                 len(twiddles.radices2), _c_ints(radices),
                 _c_ints(twiddles.bases2 + twiddles.bases1), stream)
    if err != 0:
        raise RuntimeError(f"fft2 kernel launch failed: cudaError_t {err} "
                           f"({n1}x{n2}, signals={sigs}, tile_b={tile}, "
                           f"{x.dtype})")
    return 1
