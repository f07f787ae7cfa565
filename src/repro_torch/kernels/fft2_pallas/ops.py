"""Public wrapper of the fused rank-2 kernel: per-axis schedules, one
shared twiddle pack (host float64), the register passes of one block
(``stockham_pallas.block``), launch, normalization.

``fft2`` launches the CUDA kernel (``repro_torch/csrc/fft2.cu``) for a
tensor on the card and takes the plain version (``ref.apply2_passes``)
only for a tensor on the CPU.  ``rfft2`` / ``irfft2`` are its real-input
folds over the last two axes (an even last extent n2 on the packed n1 x
n2/2 tile that one block holds): numpy's rfftn / irfftn in one launch, the
pack and unpack inside the kernel; on a CPU tensor they run
``fft/rfft.py``'s ``rfftn_packed`` / ``irfftn_packed`` around the plain
stages.  A tile over the one-block cap (up to the reference's
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
from ...fft import rfft as rfft_mod
from ...fft.reference import half_roots
from ..stockham_pallas import block
from ..stockham_pallas import ops as sp
from ..stockham_pallas.ops import (SMEM_LIMIT_BYTES, direction_of, interleave,
                                   pack_twiddles, stage_bases)
from .fft2_pallas import SMEM_TARGET_BYTES, pow2, schedules, smem_bytes
from .ref import apply2_passes

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
    """Signals per block: as many as fill ``SMEM_TARGET_BYTES`` with one
    padded buffer (at least one), never more than the batch."""
    per_sig = max(1, (n_elems + n_elems // 16) * itemsize
                  if n_stages > 1 else 0)
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
    passes = block.group_passes(plan.n1, plan.n2, plan.radices2, plan.bases2,
                                plan.radices1, plan.bases1, 1,
                                x.element_size())[0]
    rows = tuple(1 if p.rb == 1 else 2 for p in passes
                 if not p.col and p.ra > 1)
    cols = tuple(1 if p.rb == 1 else 2 for p in passes if p.col)
    return apply2_passes(x, plan.tw, plan.radices1, plan.radices2,
                         plan.bases1, plan.bases2, cols, rows, inverse)


@functools.cache
def _kernel(dtype: torch.dtype):
    """The library's one-block entry for ``dtype`` (the complex transform
    and the fold), its signature set once."""
    lib = _build.library("fft2")
    return block.entry(lib.fft2_block_f64 if dtype == torch.complex128
                       else lib.fft2_block_f32)


def layout(plan: Twiddles2, tile: int, itemsize: int, mode: int = block.C2C,
           inverse: bool = False) -> block.Layout:
    """The one-block kernel's launch of ``tile`` signals under ``plan``:
    the row (n2) stages, then the column (n1) stages."""
    return block.block_layout(plan.n1, plan.n2, plan.radices2, plan.bases2,
                              plan.radices1, plan.bases1, tile, itemsize,
                              mode, inverse)


@functools.lru_cache(maxsize=1024)
def _struct(lay: block.Layout, **fold) -> block.BlockPlanC:
    return lay.struct(**fold)


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


def _tile(n: int, sigs: int, itemsize: int, n_stages: int,
          tile_b: int | None, what: str, dtype) -> int:
    tile = tile_b if tile_b is not None else default_tile_b(
        n, sigs, itemsize, n_stages)
    tile = min(tile, sigs)
    if tile < 1 or tile * n >= 1 << 30:
        raise ValueError(f"tile_b={tile_b} does not fit one block for "
                         f"{what} {dtype} (shared memory limit "
                         f"{SMEM_LIMIT_BYTES} bytes)")
    return tile


def _launch_block(x: torch.Tensor, y: torch.Tensor, plan: Twiddles2,
                  sigs: int, tile_b: int | None, inverse: bool, mode: int,
                  roots: torch.Tensor | None, what: str,
                  cdtype: torch.dtype, **fold) -> None:
    n = plan.n1 * plan.n2
    itemsize = 16 if cdtype == torch.complex128 else 8
    n_stages = len(plan.radices1) + len(plan.radices2)
    tile = _tile(n, sigs, itemsize, n_stages, tile_b, what, cdtype)
    try:
        lay = layout(plan, tile, itemsize, mode, inverse)
    except ValueError as err:
        raise ValueError(f"tile_b={tile_b} does not fit one block for "
                         f"{what} {cdtype}: {err}") from None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel(cdtype)(
            x.data_ptr(), y.data_ptr(), plan.tw.data_ptr(),
            roots.data_ptr() if roots is not None else None,
            ctypes.byref(_struct(lay, **fold)), sigs, int(inverse),
            lay.family, 1.0 / n, lay.threads, lay.smem, stream)
    if err != 0:
        raise RuntimeError(f"fft2 kernel launch failed: cudaError_t {err} "
                           f"({what}, signals={sigs}, tile_b={tile}, "
                           f"{cdtype}, inverse={inverse})")


def _run_one_block(x: torch.Tensor, y: torch.Tensor, twiddles: Twiddles2,
                   tile_b: int | None, inverse: bool) -> int:
    n1, n2 = x.shape[-2], x.shape[-1]
    sigs = x.numel() // (n1 * n2)
    _launch_block(x, y, twiddles, sigs, tile_b, inverse, block.C2C, None,
                  f"{n1}x{n2}", x.dtype)
    return 1


# ---------------------------------------------------------------------------
# the real-input folds over the last two axes (an even n2): numpy's rfftn /
# irfftn in one launch, the pack and unpack in the kernel's passes
# ---------------------------------------------------------------------------
def _fold_plan(n1: int, n2: int, radix: int, inverse: bool,
               cdtype: torch.dtype, device, twiddles, roots):
    """The fold's plan: the packed n1 x n2/2 tile's one-block twiddles and
    the pack table ``half_roots(n2)``; raises for a tile the fold does not
    take (an odd or non-power-of-two n2, over one block) or a plan that
    does not match."""
    h = n2 // 2
    if n2 % 2 or not (pow2(n1) and pow2(h)):
        raise ValueError("the fft2_pallas fold takes power-of-two extents "
                         f"with an even last one, got {n1}x{n2}")
    if n1 * h > ONE_BLOCK_ELEMS[cdtype]:
        raise ValueError(f"the fft2_pallas fold takes a packed tile within "
                         f"one block (n1*n2/2 <= {ONE_BLOCK_ELEMS[cdtype]} "
                         f"for {cdtype}); got {n1}x{n2}")
    if twiddles is None:
        twiddles = make_twiddles2(n1, h, radix, inverse, cdtype, device)
    elif not (isinstance(twiddles, Twiddles2) and _matches(
            twiddles, n1, h, radix, inverse, cdtype, device)):
        raise ValueError(f"twiddles do not match this fold: plan "
                         f"{twiddles.n1}x{twiddles.n2}; call {n1}x{n2} "
                         f"(packed {n1}x{h}) radix={radix} {cdtype} on "
                         f"{device} inverse={inverse}")
    if roots is None:
        roots = half_roots(n2, inverse, cdtype, device=device)
    return twiddles, roots


def _count(kind: str, n1: int, n2: int, sigs: int, cdtype) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCH_SHAPES[(kind, n1, n2, sigs, str(cdtype).removeprefix("torch."))] \
        += 1


def rfft2(x: torch.Tensor, *, tile_b: int | None = None, radix: int = 8,
          twiddles: Twiddles2 | None = None,
          roots: torch.Tensor | None = None) -> torch.Tensor:
    """numpy's rfftn over the last two axes of real ``x`` (n1 x n2, powers
    of two, n2 even; float32 -> complex64, float64 -> complex128): n1 x
    (n2/2 + 1) bins.  One launch for a tensor on the card: the real tile
    read as n1 x n2/2 complex points, the unpack (the reversal mod both
    axes) in the kernel's last pass.  The packed tile must fit one block
    (``ONE_BLOCK_ELEMS``).  ``twiddles`` is the packed tile's forward plan
    (``make_twiddles2(n1, n2 // 2, ...)``), ``roots`` ``half_roots(n2)``.
    On a CPU tensor: ``fft/rfft.py``'s ``rfftn_packed`` around the plain
    stages."""
    if x.ndim < 2:
        raise ValueError(f"rfft2 needs rank >= 2 input, got shape "
                         f"{tuple(x.shape)}")
    if x.is_complex():
        raise TypeError(f"rfft2 takes real input, got {x.dtype}")
    if x.dtype not in (torch.float32, torch.float64):
        x = x.to(torch.float32)
    cdtype = torch.complex128 if x.dtype == torch.float64 \
        else torch.complex64
    n1, n2 = x.shape[-2], x.shape[-1]
    twiddles, roots = _fold_plan(n1, n2, radix, False, cdtype, x.device,
                                 twiddles, roots)
    if x.device.type == "cpu":
        return rfft_mod.rfftn_packed(x, lambda z: fft2(
            z, False, radix=radix, twiddles=twiddles), 2, roots)
    if x.device.type != "cuda":
        raise ValueError(f"fft2_pallas runs on cuda or cpu, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("fft2_pallas rfft2 needs a contiguous tensor (the "
                         "two transformed axes last, row-major)")
    h = n2 // 2
    sigs = x.numel() // (n1 * n2)
    y = torch.empty((*x.shape[:-1], h + 1), dtype=cdtype, device=x.device)
    if sigs:
        _launch_block(x, y, twiddles, sigs, tile_b, False, block.EVEN, roots,
                      f"{n1}x{n2} (packed {n1}x{h})", cdtype, nyq=h,
                      out_sig=n1 * (h + 1), out_row=h + 1)
        _count("rfft2", n1, n2, sigs, cdtype)
    return y


def irfft2(y: torch.Tensor, n2: int, *, tile_b: int | None = None,
           radix: int = 8, twiddles: Twiddles2 | None = None,
           roots: torch.Tensor | None = None) -> torch.Tensor:
    """numpy's irfftn over the last two axes of ``y`` (n1 x (n2/2 + 1)
    bins; the output n1 x n2 reals, 1/(n1 n2) applied).  One launch for a
    tensor on the card: the pack in the kernel's first pass, the real
    output stored as n1 x n2/2 complex points.  ``twiddles`` is the packed
    tile's inverse plan, ``roots`` ``half_roots(n2, inverse=True)``.  On a
    CPU tensor: ``fft/rfft.py``'s ``irfftn_packed`` around the plain
    stages."""
    if y.ndim < 2:
        raise ValueError(f"irfft2 needs rank >= 2 input, got shape "
                         f"{tuple(y.shape)}")
    cdtype = y.dtype if y.is_complex() else (
        torch.complex128 if y.dtype == torch.float64 else torch.complex64)
    if cdtype not in _CDTYPES:
        raise TypeError(f"irfft2 takes complex64/complex128, got {y.dtype}")
    y = y.to(cdtype)
    n1 = y.shape[-2]
    if y.shape[-1] != n2 // 2 + 1:
        raise ValueError(f"irfft2 of n2={n2} takes {n2 // 2 + 1} bins, got "
                         f"{y.shape[-1]}")
    twiddles, roots = _fold_plan(n1, n2, radix, True, cdtype, y.device,
                                 twiddles, roots)
    if y.device.type == "cpu":
        return rfft_mod.irfftn_packed(y, (n1, n2), lambda z, inverse=False:
                                      fft2(z, inverse, radix=radix,
                                           twiddles=twiddles), roots)
    if y.device.type != "cuda":
        raise ValueError(f"fft2_pallas runs on cuda or cpu, got {y.device}")
    if not y.is_contiguous():
        raise ValueError("fft2_pallas irfft2 needs a contiguous tensor (the "
                         "two transformed axes last, row-major)")
    h = n2 // 2
    sigs = y.numel() // (n1 * (h + 1))
    x = torch.empty((*y.shape[:-1], n2), dtype=sp._real_dtype(cdtype),
                    device=y.device)
    if sigs:
        _launch_block(y, x, twiddles, sigs, tile_b, True, block.EVEN, roots,
                      f"{n1}x{n2} (packed {n1}x{h})", cdtype, nyq=h,
                      in_sig=n1 * (h + 1), in_row=h + 1)
        _count("irfft2", n1, n2, sigs, cdtype)
    return x
