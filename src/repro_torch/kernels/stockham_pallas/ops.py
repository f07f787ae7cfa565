"""Public wrapper of the fused Stockham kernel: schedule, twiddle packing
(host float64), the one-block kernel's register passes (``block_layout``:
the stages grouped into passes, the threads, the padded shared-memory
layouts), launch, normalization.

``fft`` launches the CUDA kernel (``repro_torch/csrc/stockham.cu``) for a
tensor on the card and takes the plain version (``ref.apply_passes``, or
``ref.apply_two_pass`` over the one-block cap) only for a tensor on the
CPU.  An axis that one block holds runs in one launch; a longer one, up
to the reference's 2^20, in two column passes through global memory
(``TwoPass``).  ``rfft`` / ``irfft`` are the real-input folds of one
block's axis (the same one-block kernels of ``csrc/stockham.cu`` and
``csrc/stockham64.cu``, their mode set by the plan; the fold's passes
live in ``csrc/stockham_stages.cuh``): numpy's rfft / irfft along the
last axis in one launch, the R2C pack and unpack inside the kernel; on a
CPU tensor they run ``fft/rfft.py``'s packing around the plain stages.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from ...fft import rfft as rfft_mod
from ...fft.reference import half_roots
from .. import _build
from . import block
from .ref import apply_passes, apply_two_pass, run_columns
from .stockham_pallas import radix_schedule, smooth7

#: Shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT_BYTES = 232448

#: Shared memory the default batch tile aims for: small enough that several
#: blocks share an SM.
SMEM_TARGET_BYTES = 32 << 10

_CDTYPES = (torch.complex64, torch.complex128)

#: Kernel launches, and launches by (n, rows, dtype); wrappers add to both
#: where they launch the kernel and nowhere else.
LAUNCHES = 0
LAUNCH_SHAPES: Counter = Counter()
#: Launches of the column pass (``stockham_columns_kernel``) by its own
#: callers' wrappers (this module's and ``fft2_pallas``'s): a part of
#: their counts, added where the column kernel launches.
COLUMN_LAUNCHES = 0


def smem_bytes(n: int, tile_b: int, itemsize: int, n_stages: int) -> int:
    """The most dynamic shared memory one block can need: two buffers of
    ``tile_b`` rows (the fallback of ``block_layout``; one padded buffer,
    its rule, is less), or none for a single-stage schedule (global in,
    global out).  ``itemsize`` is the complex element size."""
    return 2 * tile_b * n * itemsize if n_stages > 1 else 0


def _largest_fitting(itemsize: int) -> int:
    n = SMEM_LIMIT_BYTES // (2 * itemsize)
    while not smooth7(n):
        n -= 1
    return n


#: Longest axis one block holds (tile_b = 1, two buffers in shared
#: memory): 14406 = 2*3*7^4 for complex64, 7203 = 3*7^4 for complex128.
#: Longer axes run as two passes (``TwoPass``); this cap is internal.
ONE_BLOCK_N = {torch.complex64: _largest_fitting(8),
               torch.complex128: _largest_fitting(16)}

#: Longest axis the kernel takes: the reference's 2^20, in both dtypes.
MAX_N = {torch.complex64: 1 << 20, torch.complex128: 1 << 20}

#: Bytes of a row-run the column pass aims for (``column_layout``'s rule):
#: 128 bytes, one line of the L2 (16 complex64 / 8 complex128 adjacent
#: columns).
COLUMN_RUN_BYTES = 128

#: Entries of the low root table of the two-pass twiddle: W_n^e is
#: hi[e >> 10] * lo[e & 1023] (``kRootLo`` in the kernel).
ROOT_LO = 1024


def check_length(n: int, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` for a length the kernel cannot take."""
    if not smooth7(n):
        raise ValueError("stockham_pallas requires a 7-smooth "
                         f"(2^a*3^b*5^c*7^d) length, got {n}")
    if n > MAX_N[dtype]:
        raise ValueError(f"stockham_pallas caps at n={MAX_N[dtype]} for "
                         f"{dtype}, as the reference does; got {n}")


def choose_split(n: int, dtype: torch.dtype) -> tuple[int, int]:
    """The two-pass split n = n1*n2 of an axis: the most balanced one
    with n1 <= n2 and n2 within the one-block cap (both factors are
    7-smooth when n is)."""
    cap = ONE_BLOCK_N[dtype]
    n1 = next((d for d in range(math.isqrt(n), 1, -1)
               if n % d == 0 and n // d <= cap), None)
    if n1 is None:
        raise ValueError(f"n={n} has no split n1*n2 with both factors "
                         f"within the one-block cap {cap} for {dtype}")
    return n1, n // n1


def column_layout(stages: "Twiddles", width: int, itemsize: int,
                  k_fast: bool) -> block.Layout:
    """The column pass's launch (``block.column_layout``) over ``width``
    columns of ``stages.n`` points: a block holds the fewest adjacent
    columns whose row-run is ``COLUMN_RUN_BYTES`` (no more than the width
    needs), halved while the layout does not fit a block (measured on the
    card, the run is worth more than blocks sharing an SM); ``k_fast``:
    the output's unit stride is along k (a transposed store), so the last
    pass takes its butterflies fastest across a warp."""
    def lay(c: int) -> block.Layout:
        return block.column_layout(stages.n, c, stages.radices,
                                   stages.bases, itemsize, k_fast)
    c = 1
    while c * itemsize < COLUMN_RUN_BYTES and c < width:
        c *= 2
    while c > 1:
        try:
            return lay(c)
        except ValueError:
            c //= 2
    return lay(1)


def pass_roots(n: int, inverse: bool, dtype: torch.dtype,
               device) -> torch.Tensor:
    """The two-pass twiddle's root tables for W_n^e, e < n: W_n^b for
    b < ``ROOT_LO``, then W_n^(ROOT_LO*a) for a < ceil(n / ROOT_LO); built
    in float64 with exact integer reduction, cast once to ``dtype``."""
    sign = 2.0 if inverse else -2.0
    e = np.concatenate([np.arange(ROOT_LO) % n,
                        (ROOT_LO * np.arange(-(-n // ROOT_LO))) % n])
    w = np.exp(1j * (sign * np.pi / n) * e.astype(np.float64))
    return torch.from_numpy(w).to(device=device, dtype=dtype)


def pack_twiddles(n: int, radices: tuple[int, ...], inverse: bool,
                  real_dtype) -> tuple[np.ndarray, np.ndarray,
                                       tuple[tuple[int, ...], ...]]:
    """Per-stage twiddle planes W_cur^{p*u} (u = 1..r-1, p < cur/r) packed
    into one (1, L) pair plus per-(stage, u) offsets, in the reference
    package's exact layout (zero-padded to a multiple of 128).

    Angles use exact integer reduction of p*u mod cur before the float64
    conversion, so float32 twiddles stay accurate at any length.
    """
    sign = 2.0 if inverse else -2.0
    re_chunks, im_chunks, offsets = [], [], []
    off, cur = 0, n
    for r in radices:
        m = cur // r
        stage_offs = []
        p = np.arange(m, dtype=np.int64)
        for u in range(1, r):
            ang = (sign * np.pi / cur) * ((u * p) % cur).astype(np.float64)
            re_chunks.append(np.cos(ang))
            im_chunks.append(np.sin(ang))
            stage_offs.append(off)
            off += m
        offsets.append(tuple(stage_offs))
        cur = m
    pad = (-off) % 128 or (128 if off == 0 else 0)
    re_chunks.append(np.zeros(pad))
    im_chunks.append(np.zeros(pad))
    twr = np.concatenate(re_chunks)[None, :].astype(real_dtype)
    twi = np.concatenate(im_chunks)[None, :].astype(real_dtype)
    return twr, twi, tuple(offsets)


@dataclass(frozen=True)
class Twiddles:
    """A plan's device state: the schedule and its packed twiddles as one
    interleaved complex vector (``pack_twiddles`` without its padding).
    ``inverse`` is None when every twiddle is 1 (a single-stage schedule
    serves both directions)."""

    n: int
    radices: tuple[int, ...]
    bases: tuple[int, ...]
    tw: torch.Tensor
    inverse: bool | None

    @property
    def nbytes(self) -> int:
        return self.tw.numel() * self.tw.element_size()


def stage_bases(offsets: tuple[tuple[int, ...], ...]) -> tuple[int, ...]:
    """Each stage's base in the packed vector (its u = 1 offset), from
    ``pack_twiddles``' per-(stage, u) offsets."""
    return tuple(o[0] for o in offsets)


def packed_length(radices: tuple[int, ...]) -> int:
    """Twiddles one axis' schedule uses, without ``pack_twiddles``'
    padding."""
    length, cur = 0, int(np.prod(radices))
    for r in radices:
        cur //= r
        length += (r - 1) * cur
    return length


def direction_of(twi: np.ndarray) -> bool | None:
    """The direction a packed imaginary plane was built for, or None when
    every twiddle is 1 (a single-stage schedule serves both directions):
    the first stage with m > 1 holds W_cur^1 at its p = 1 slot, whose
    imaginary part has the transform's sign."""
    nontrivial = np.flatnonzero(np.abs(twi) > 0)
    return bool(twi[nontrivial[0]] > 0) if nontrivial.size else None


def interleave(twr: np.ndarray, twi: np.ndarray, dtype: torch.dtype,
               device) -> torch.Tensor:
    """Real and imaginary planes as one interleaved complex vector of
    ``dtype`` on ``device``."""
    planes = np.stack([twr, twi], axis=-1)
    tw = torch.view_as_complex(torch.from_numpy(np.ascontiguousarray(planes)))
    return tw.to(device=device, dtype=dtype)


def _from_planes(twr: np.ndarray, twi: np.ndarray,
                 offsets: tuple[tuple[int, ...], ...], dtype: torch.dtype,
                 device) -> Twiddles:
    radices = tuple(len(o) + 1 for o in offsets)
    length = packed_length(radices)
    tw = interleave(twr[0, :length], twi[0, :length], dtype, device) \
        if length else torch.zeros(1, dtype=dtype, device=device)
    return Twiddles(int(np.prod(radices)), radices, stage_bases(offsets), tw,
                    direction_of(twi[0, :length]))


@dataclass(frozen=True)
class TwoPass:
    """A plan for an axis over the one-block cap: the split n = n1*n2,
    the column schedule (``column_schedule``) and twiddles of each pass
    (``first``: the n1-point column FFTs, ``second``: the n2-point ones)
    and the pass twiddle's root tables (``pass_roots``)."""

    n: int
    n1: int
    n2: int
    first: Twiddles
    second: Twiddles
    roots: torch.Tensor
    inverse: bool

    @property
    def nbytes(self) -> int:
        return (self.first.nbytes + self.second.nbytes
                + self.roots.numel() * self.roots.element_size())


def column_schedule(n: int, radix: int, dtype: torch.dtype
                    ) -> tuple[int, ...]:
    """The stage schedule of a column pass of length ``n`` (a two-pass
    plan's, fft2's columns over one block): ``radix_schedule``'s, except
    that in complex64 at radix 8 the power-of-two stages run as 8x4
    pairs, the column kernel's 32-point register pass (a remainder of 2^4
    as 4x4), so that 1024 points are two passes and the first pass the
    largest."""
    radices = radix_schedule(n, radix)
    if radix != 8 or dtype != torch.complex64:
        return radices
    odd = tuple(r for r in radices if r % 2)
    k = (n // math.prod(odd)).bit_length() - 1
    pow2 = (8, 4) * (k // 5) + {0: (), 1: (2,), 2: (4,), 3: (8,),
                                4: (4, 4)}[k % 5]
    return odd + pow2


def _one_block(n: int, radix: int, inverse: bool, dtype: torch.dtype,
               device, radices: tuple[int, ...] | None = None) -> Twiddles:
    radices = radices or radix_schedule(n, radix)
    real = np.float64 if dtype == torch.complex128 else np.float32
    return _from_planes(*pack_twiddles(n, radices, inverse, real), dtype,
                        device)


def make_twiddles(n: int, radix: int, inverse: bool, dtype: torch.dtype,
                  device, split: tuple[int, int] | None = None,
                  columns: bool = False) -> Twiddles | TwoPass:
    """Build the plan for length ``n`` on ``device``: schedules, twiddles
    in float64 on the host, cast once to ``dtype``'s precision and
    uploaded.  One block's plan up to ``ONE_BLOCK_N``, else a ``TwoPass``
    over ``choose_split``; ``split`` forces two passes over that split.
    ``columns``: a plan that only the column pass runs (fft2's columns
    over its one-block cap), on ``column_schedule`` at any length."""
    check_length(n, dtype)
    if split is None and n <= ONE_BLOCK_N[dtype]:
        return _one_block(n, radix, inverse, dtype, device,
                          column_schedule(n, radix, dtype) if columns
                          else None)
    n1, n2 = split or choose_split(n, dtype)
    if n1 * n2 != n or min(n1, n2) < 2 or max(n1, n2) > ONE_BLOCK_N[dtype]:
        raise ValueError(f"split {n1}x{n2} is not a two-pass split of "
                         f"n={n} for {dtype}")
    return TwoPass(n, n1, n2, *(
        _one_block(m, radix, inverse, dtype, device,
                   column_schedule(m, radix, dtype)) for m in (n1, n2)),
        pass_roots(n, inverse, dtype, device), inverse)


def _describe(plan: Twiddles | TwoPass) -> str:
    if isinstance(plan, TwoPass):
        return (f"n={plan.n} split {plan.n1}x{plan.n2} radices="
                f"{plan.first.radices}/{plan.second.radices} "
                f"{plan.roots.dtype} on {plan.roots.device} "
                f"inverse={plan.inverse}")
    return (f"n={plan.n} radices={plan.radices} {plan.tw.dtype} on "
            f"{plan.tw.device} inverse={plan.inverse}")


def _matches(plan: Twiddles | TwoPass, n: int, radix: int, inverse: bool,
             dtype: torch.dtype, device, columns: bool = False) -> bool:
    if isinstance(plan, TwoPass):
        return (plan.n == n and plan.inverse == inverse
                and plan.first.radices == column_schedule(plan.n1, radix,
                                                          dtype)
                and plan.second.radices == column_schedule(plan.n2, radix,
                                                           dtype)
                and plan.roots.dtype == dtype
                and plan.roots.device == device)
    schedule = column_schedule(n, radix, dtype) if columns \
        else radix_schedule(n, radix)
    return (plan.n == n and n <= ONE_BLOCK_N[dtype]
            and plan.radices == schedule
            and plan.tw.dtype == dtype and plan.tw.device == device
            and plan.inverse in (None, inverse))


def twiddles_from_reference(twr: np.ndarray, twi: np.ndarray,
                            offsets: tuple[tuple[int, ...], ...],
                            device) -> Twiddles:
    """The port's plan from the reference package's ``pack_twiddles``
    output: same values, same stage bases, padding dropped."""
    dtype = torch.complex128 if twr.dtype == np.float64 else torch.complex64
    return _from_planes(twr, twi, offsets, dtype, device)


def default_tile_b(n: int, batch: int, itemsize: int, n_stages: int) -> int:
    """Rows per block: as many as fill ``SMEM_TARGET_BYTES`` with one
    padded buffer (at least one), never more than the batch."""
    per_row = max(1, (n + n // 16) * itemsize if n_stages > 1 else 0)
    return max(1, min(batch, SMEM_TARGET_BYTES // per_row))


def fft(x: torch.Tensor, inverse: bool = False, *, tile_b: int | None = None,
        radix: int = 8, twiddles: Twiddles | None = None) -> torch.Tensor:
    """Fused Stockham FFT along the last axis.

    7-smooth lengths up to ``MAX_N[dtype]`` (2^20): one launch up to
    ``ONE_BLOCK_N[dtype]``, two column passes above it; numpy semantics
    (the inverse applies 1/n).  Real input is cast to complex64.
    ``tile_b`` (rows per block, one-block lengths only) and ``radix`` are
    the tunable knobs; ``twiddles`` is a prebuilt plan (``make_twiddles``)
    that must match the call's length, schedule, dtype, device and
    direction.
    """
    if not x.is_complex():
        x = x.to(torch.complex64)
    if x.dtype not in _CDTYPES:
        raise TypeError(f"stockham_pallas takes complex64/complex128, got {x.dtype}")
    n = x.shape[-1]
    check_length(n, x.dtype)
    if n == 1:
        return x   # length-1 DFT is the identity (1/n factor is 1 too)
    if twiddles is None:
        twiddles = make_twiddles(n, radix, inverse, x.dtype, x.device)
    elif not _matches(twiddles, n, radix, inverse, x.dtype, x.device):
        raise ValueError(f"twiddles do not match this call: plan "
                         f"{_describe(twiddles)}; call n={n} radix={radix} "
                         f"{x.dtype} on {x.device} inverse={inverse}")
    if x.device.type == "cpu":
        y = plain(x, twiddles, inverse)
        return y / n if inverse else y
    if x.device.type != "cuda":
        raise ValueError(f"stockham_pallas runs on cuda or cpu, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("stockham_pallas needs a contiguous tensor "
                         "(the transformed axis last, unit stride)")
    return _launch(x, inverse, tile_b, twiddles)


@functools.cache
def _kernel(dtype: torch.dtype):
    """The library's one-block entry for complex ``dtype`` (complex
    transforms and the folds), its signature set once."""
    if dtype == torch.complex128:
        return block.entry(_build.library("stockham64").stockham_block_f64)
    return block.entry(_build.library("stockham").stockham_block_f32)


@functools.cache
def _columns_kernel(dtype: torch.dtype):
    """The column-pass entry for ``dtype`` (in the library of the
    dtype's one-block entry), its signature set once."""
    if dtype == torch.complex128:
        return block.column_entry(
            _build.library("stockham64").stockham_columns_f64)
    return block.column_entry(_build.library("stockham").stockham_columns_f32)


@functools.lru_cache(maxsize=1024)
def _column_struct(lay: block.Layout, width: int, **strides
                   ) -> block.ColumnPlanC:
    return lay.column_struct(width, **strides)


def column_pass(src: torch.Tensor, dst: torch.Tensor, stages: Twiddles,
                nsig: int, width: int, *, in_sig: int, in_k: int,
                out_k: int, out_col: int, out_big: int, out_small: int = 0,
                group: int = 1, roots: torch.Tensor | None = None,
                tw_n: int = 0, tw_q: int = 1, inverse: bool = False,
                scale: float = 1.0) -> None:
    """One column pass of ``csrc/stockham_columns.cuh``: for each of
    ``nsig`` signals and ``width`` columns, the ``stages.n``-point FFT of
    src[sig*in_sig + j*in_k + col], output k times W_tw_n^(k*(col//tw_q))
    (``roots`` from ``pass_roots``; none when tw_n is 0) and ``scale``,
    stored at dst[(sig//group)*out_big + (sig%group)*out_small + k*out_k
    + col*out_col], a block a tile of ``column_layout``.  On a tensor on
    the card it launches the kernel (adding one to
    ``COLUMN_LAUNCHES``) and raises if the launch fails; on a CPU tensor
    it runs the kernel's index model (``ref.run_columns``), which the
    tests hold against the plain version.  The caller's wrapper counts
    its own launches."""
    global COLUMN_LAUNCHES
    length = stages.n
    lay = column_layout(stages, width, src.element_size(), out_k == 1)
    strides = dict(in_sig=in_sig, in_k=in_k, out_big=out_big,
                   out_small=out_small, out_k=out_k, out_col=out_col,
                   group=group, tw_n=tw_n, tw_q=tw_q)
    if src.device.type == "cpu":
        run_columns(src.reshape(-1), dst.view(-1), lay, nsig, width,
                    stages.tw, roots, inverse, scale, **strides)
        return
    if (length - 1) * in_k + width > 1 << 31 or \
            (length - 1) * out_k + (width - 1) * out_col >= 1 << 31:
        raise ValueError(f"column pass offsets within a signal exceed "
                         f"32 bits (length={length}, width={width})")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = _columns_kernel(src.dtype)(
            src.data_ptr(), dst.data_ptr(), stages.tw.data_ptr(),
            roots.data_ptr() if roots is not None else None,
            ctypes.byref(_column_struct(lay, width, **strides)), nsig,
            int(inverse), lay.family, float(scale), lay.threads, lay.smem,
            stream)
    if err != 0:
        raise RuntimeError(f"stockham column pass failed: cudaError_t {err} "
                           f"(length={length}, width={width}, "
                           f"signals={nsig}, cols={lay.l2}, {src.dtype})")
    COLUMN_LAUNCHES += 1


def run_two_pass(x: torch.Tensor, y: torch.Tensor, plan: TwoPass,
                 inverse: bool) -> int:
    """The two column passes of ``plan`` along the last axis of ``x`` into
    ``y`` (both contiguous), through a scratch tensor; returns the number
    of launches.  Counts nothing."""
    n, n1, n2 = plan.n, plan.n1, plan.n2
    rows = x.numel() // n
    tmp = torch.empty_like(x)
    # pass 1: column j2's n1-point FFT, times W_n^(j2*k1), to tmp[j2*n1 + k1]
    column_pass(x, tmp, plan.first, rows, n2, in_sig=n, in_k=n2, out_k=1,
                out_col=n1, out_big=n, roots=plan.roots, tw_n=n,
                inverse=inverse)
    # pass 2: column k1 of tmp, n2-point FFT, to y[k2*n1 + k1]
    column_pass(tmp, y, plan.second, rows, n1, in_sig=n, in_k=n1, out_k=n1,
                out_col=1, out_big=n, inverse=inverse,
                scale=1.0 / n if inverse else 1.0)
    return 2


def layout(twiddles: Twiddles, tile: int, itemsize: int,
           mode: int = block.C2C, inverse: bool = False) -> block.Layout:
    """The one-block kernel's launch of ``tile`` rows under ``twiddles``
    (``block.block_layout`` over its schedule)."""
    return block.block_layout(1, twiddles.n, twiddles.radices,
                              twiddles.bases, (), (), tile, itemsize, mode,
                              inverse)


def _tile(n: int, rows: int, itemsize: int, n_stages: int,
          tile_b: int | None, dtype: torch.dtype) -> int:
    tile = tile_b if tile_b is not None else default_tile_b(
        n, rows, itemsize, n_stages)
    tile = min(tile, rows)
    if tile < 1 or tile * n >= 1 << 30:
        raise ValueError(f"tile_b={tile_b} does not fit one block for n={n} "
                         f"{dtype} (shared memory limit {SMEM_LIMIT_BYTES} "
                         "bytes)")
    return tile


def _fits(twiddles: Twiddles, tile: int, itemsize: int, mode: int,
          inverse: bool, tile_b: int | None, dtype) -> block.Layout:
    try:
        return layout(twiddles, tile, itemsize, mode, inverse)
    except ValueError as err:
        raise ValueError(f"tile_b={tile_b} does not fit one block for "
                         f"n={twiddles.n} {dtype}: {err}") from None


def run_one_block(x: torch.Tensor, y: torch.Tensor, twiddles: Twiddles,
                  inverse: bool, tile_b: int | None) -> int:
    """One launch of the one-block kernel along the last axis of ``x``
    into ``y`` (both contiguous, at least one row); returns 1.  Counts
    nothing."""
    n = x.shape[-1]
    rows = x.numel() // n
    itemsize = x.element_size()
    tile = _tile(n, rows, itemsize, len(twiddles.radices), tile_b, x.dtype)
    lay = _fits(twiddles, tile, itemsize, block.C2C, inverse, tile_b,
                x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel(x.dtype)(
            x.data_ptr(), y.data_ptr(), twiddles.tw.data_ptr(), None,
            ctypes.byref(_struct(lay)), rows, int(inverse), lay.family,
            1.0 / n, lay.threads, lay.smem, stream)
    if err != 0:
        raise RuntimeError(f"stockham kernel launch failed: cudaError_t {err} "
                           f"(n={n}, rows={rows}, tile_b={tile}, {x.dtype})")
    return 1


@functools.lru_cache(maxsize=1024)
def _struct(lay: block.Layout, **fold) -> block.BlockPlanC:
    return lay.struct(**fold)


def run_plan(x: torch.Tensor, y: torch.Tensor, plan: Twiddles | TwoPass,
             inverse: bool, tile_b: int | None = None) -> int:
    """The plan's launches along the last axis of ``x`` into ``y`` (both
    contiguous, at least one row): one block's, or two column passes
    (which take no batch tile); returns the number of launches.  Counts
    nothing: the calling wrapper counts."""
    if isinstance(plan, TwoPass):
        if tile_b is not None:
            raise ValueError(f"tile_b={tile_b} does not fit one block for "
                             f"n={plan.n} {x.dtype}: the axis runs as two "
                             "column passes, which take no batch tile")
        return run_two_pass(x, y, plan, inverse)
    return run_one_block(x, y, plan, inverse, tile_b)


def plain(x: torch.Tensor, plan: Twiddles | TwoPass,
          inverse: bool) -> torch.Tensor:
    """The kernel's arithmetic under ``plan`` along the last axis of
    complex ``x`` in plain torch, on any device; no 1/n scaling."""
    if isinstance(plan, TwoPass):
        t1, t2 = plan.first, plan.second
        return apply_two_pass(x, plan.n1, plan.n2,
                              (t1.tw, t1.radices, t1.bases),
                              (t2.tw, t2.radices, t2.bases), plan.roots,
                              inverse)
    groups = tuple(1 if p.rb == 1 else 2 for p in block.group_passes(
        1, plan.n, plan.radices, plan.bases, (), (), 1, x.element_size())[0]
        if p.ra > 1)   # a one-point plan's identity pass has no stage
    return apply_passes(x, plan.tw, plan.radices, plan.bases, groups, inverse)


def _launch(x: torch.Tensor, inverse: bool, tile_b: int | None,
            twiddles: Twiddles | TwoPass) -> torch.Tensor:
    global LAUNCHES
    n = x.shape[-1]
    rows = x.numel() // n
    y = torch.empty_like(x)
    if rows == 0:
        return y
    launched = run_plan(x, y, twiddles, inverse, tile_b)
    LAUNCHES += launched
    LAUNCH_SHAPES[(n, rows, str(x.dtype).removeprefix("torch."))] += launched
    return y


# ---------------------------------------------------------------------------
# the real-input folds: numpy's rfft / irfft along the last axis in one
# launch of the one-block kernel (csrc/stockham.cu, csrc/stockham64.cu)
# ---------------------------------------------------------------------------
def _real_dtype(cdtype: torch.dtype) -> torch.dtype:
    return torch.float64 if cdtype == torch.complex128 else torch.float32


def _fold_plan(n: int, radix: int, inverse: bool, cdtype: torch.dtype,
               device, twiddles: Twiddles | None, roots: torch.Tensor | None
               ) -> tuple[Twiddles, torch.Tensor | None]:
    """The fold's plan: the one-block twiddles of the packed length (n/2
    for an even n, n for an odd one) and, for an even n, the pack table
    ``half_roots(n)``; raises for a length the fold does not take (over
    one block, or not 7-smooth) or a plan that does not match."""
    m = n // 2 if n % 2 == 0 else n
    if not smooth7(m) or m > ONE_BLOCK_N[cdtype]:
        raise ValueError(f"the stockham_pallas fold takes a 7-smooth packed "
                         f"length within one block (<= {ONE_BLOCK_N[cdtype]} "
                         f"for {cdtype}); got n={n}")
    if twiddles is None:
        twiddles = make_twiddles(m, radix, inverse, cdtype, device)
    elif not (isinstance(twiddles, Twiddles)
              and _matches(twiddles, m, radix, inverse, cdtype, device)):
        raise ValueError(f"twiddles do not match this fold: plan "
                         f"{_describe(twiddles)}; call n={n} (packed {m}) "
                         f"radix={radix} {cdtype} on {device} "
                         f"inverse={inverse}")
    if n % 2 == 0 and roots is None:
        roots = half_roots(n, inverse, cdtype, device=device)
    return twiddles, roots


def fold_layout(n: int, twiddles: Twiddles, tile: int, itemsize: int,
                inverse: bool) -> block.Layout:
    """The fold's launch of ``tile`` rows of length ``n``."""
    mode = block.EVEN if n % 2 == 0 else block.ODD
    return layout(twiddles, tile, itemsize, mode, inverse)


def _fold_struct(n: int, lay: block.Layout, inverse: bool):
    bins = n // 2 + 1
    nyq = n // 2
    return _struct(lay, nyq=nyq, **({"in_sig": bins, "in_row": bins}
                                    if inverse else
                                    {"out_sig": bins, "out_row": bins}))


def _run_fold(x: torch.Tensor, y: torch.Tensor, n: int, rows: int,
              twiddles: Twiddles, roots, inverse: bool,
              tile_b: int | None, cdtype: torch.dtype) -> None:
    m = twiddles.n
    itemsize = 16 if cdtype == torch.complex128 else 8
    tile = _tile(m, rows, itemsize, len(twiddles.radices), tile_b, cdtype)
    try:
        lay = fold_layout(n, twiddles, tile, itemsize, inverse)
    except ValueError as err:
        raise ValueError(f"tile_b={tile_b} does not fit one block for "
                         f"n={n} {cdtype}: {err}") from None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel(cdtype)(
            x.data_ptr(), y.data_ptr(), twiddles.tw.data_ptr(),
            roots.data_ptr() if roots is not None else None,
            ctypes.byref(_fold_struct(n, lay, inverse)), rows, int(inverse),
            lay.family, 1.0 / (n if n % 2 else m), lay.threads, lay.smem,
            stream)
    if err != 0:
        raise RuntimeError(f"stockham fold launch failed: cudaError_t {err} "
                           f"(n={n}, rows={rows}, tile_b={tile}, {cdtype}, "
                           f"inverse={inverse})")


def _count(kind: str, n: int, rows: int, cdtype: torch.dtype) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCH_SHAPES[(kind, n, rows, str(cdtype).removeprefix("torch."))] += 1


def rfft(x: torch.Tensor, *, tile_b: int | None = None, radix: int = 8,
         twiddles: Twiddles | None = None,
         roots: torch.Tensor | None = None) -> torch.Tensor:
    """numpy's rfft along the last axis of real ``x`` (float32 ->
    complex64, float64 -> complex128; other reals cast to float32): n//2+1
    bins.  One launch of the fold kernel for a tensor on the card: an even
    n packed as n/2 complex points with the unpack in the kernel's last
    pass, an odd n as real values with bins 0..n/2 stored.  The packed
    length must be 7-smooth and within one block (``ONE_BLOCK_N``).
    ``twiddles`` is the packed length's forward plan (``make_twiddles``),
    ``roots`` the even n's ``half_roots(n)``.  On a CPU tensor:
    ``fft/rfft.py``'s packing around the plain stages."""
    if x.is_complex():
        raise TypeError(f"rfft takes real input, got {x.dtype}")
    if x.dtype not in (torch.float32, torch.float64):
        x = x.to(torch.float32)
    cdtype = torch.complex128 if x.dtype == torch.float64 \
        else torch.complex64
    n = x.shape[-1]
    if n == 1:
        return x.to(cdtype)   # the one-point DFT is the identity
    twiddles, roots = _fold_plan(n, radix, False, cdtype, x.device, twiddles,
                                 roots)
    if x.device.type == "cpu":
        return rfft_mod.rfft(x, lambda z: fft(z, False, radix=radix,
                                              twiddles=twiddles), roots)
    if x.device.type != "cuda":
        raise ValueError(f"stockham_pallas runs on cuda or cpu, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("stockham_pallas rfft needs a contiguous tensor "
                         "(the transformed axis last, unit stride)")
    rows = x.numel() // n
    y = torch.empty((*x.shape[:-1], n // 2 + 1), dtype=cdtype,
                    device=x.device)
    if rows:
        _run_fold(x, y, n, rows, twiddles, roots, False, tile_b, cdtype)
        _count("rfft", n, rows, cdtype)
    return y


def irfft(y: torch.Tensor, n: int, *, tile_b: int | None = None,
          radix: int = 8, twiddles: Twiddles | None = None,
          roots: torch.Tensor | None = None) -> torch.Tensor:
    """numpy's irfft along the last axis of ``y`` (n//2+1 bins; the output
    has n reals; 1/n applied).  One launch of the fold kernel for a tensor
    on the card: an even n's pack in the kernel's first pass and the real
    output stored as n/2 complex points, an odd n's Hermitian half rebuilt
    on load and the real parts stored.  ``twiddles`` is the packed
    length's inverse plan, ``roots`` the even n's ``half_roots(n,
    inverse=True)``.  On a CPU tensor: ``fft/rfft.py``'s packing around
    the plain stages."""
    cdtype = y.dtype if y.is_complex() else (
        torch.complex128 if y.dtype == torch.float64 else torch.complex64)
    if cdtype not in _CDTYPES:
        raise TypeError(f"irfft takes complex64/complex128, got {y.dtype}")
    y = y.to(cdtype)
    if y.shape[-1] != n // 2 + 1:
        raise ValueError(f"irfft of n={n} takes {n // 2 + 1} bins, got "
                         f"{y.shape[-1]}")
    if n == 1:
        return y.real.contiguous()   # the one-point DFT is the identity
    twiddles, roots = _fold_plan(n, radix, True, cdtype, y.device, twiddles,
                                 roots)
    if y.device.type == "cpu":
        return rfft_mod.irfft(y, n, lambda z, inverse=False: fft(
            z, inverse, radix=radix, twiddles=twiddles), roots)
    if y.device.type != "cuda":
        raise ValueError(f"stockham_pallas runs on cuda or cpu, got {y.device}")
    if not y.is_contiguous():
        raise ValueError("stockham_pallas irfft needs a contiguous tensor "
                         "(the transformed axis last, unit stride)")
    rows = y.numel() // (n // 2 + 1)
    x = torch.empty((*y.shape[:-1], n), dtype=_real_dtype(cdtype),
                    device=y.device)
    if rows:
        _run_fold(y, x, n, rows, twiddles, roots, True, tile_b, cdtype)
        _count("irfft", n, rows, cdtype)
    return x
