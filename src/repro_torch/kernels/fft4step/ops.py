"""Public wrapper of the fused four-step kernel: factor choice, the W1, W2
and T tables and the kernel's root tables (host float64, cast once to the
plane dtype), the body of the split, shared-memory sizing, launch,
normalization.

``fft`` launches the CUDA kernel (``repro_torch/csrc/fft4step.cu``) for a
tensor on the card, its FFT body where both sides of the split are
7-smooth (``fft_body``) and its product body elsewhere, and takes the
body's plain version (``plain``: ``ref.apply_fourstep_fft`` or
``ref.apply_fourstep``) only for a tensor on the CPU.  ``LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ...fft.reference import dft_matrix, twiddles as twiddle_grid, unit_roots
from ..stockham_pallas.ops import SMEM_LIMIT_BYTES, direction_of
from .fft4step import (CARD_SMS, MAX_FACTOR, MAX_PASSES, SM_SMEM_BYTES,
                       TWIDDLE_ROOTS, WARPS, choose_factors, column_items, fft_body, fft_pass_tiles,
                       fft_pitch, fft_threads, fft_tile_b, m_group, n_tiles,
                       plane_pitch, product_smem_bytes, side_radices,
                       smem_bytes)
from .ref import apply_fourstep, apply_fourstep_fft

_CDTYPES = (torch.complex64, torch.complex128)

#: Kernel launches, and launches by (n, rows, dtype); the wrapper adds to
#: both where it launches the kernel and nowhere else.
LAUNCHES = 0
LAUNCH_SHAPES: Counter = Counter()


def one_block(n1: int, n2: int, itemsize: int) -> bool:
    """Does one block hold a signal of the split n1 x n2 (the product
    body's padded plane and root tables)?  Else the kernel runs two
    launches.  Both bodies keep this rule (where the product body's block
    fits, the FFT body's does: its tables are no larger and its pitch
    falls back to the unpadded row where the odd one would not fit), so
    a split launches alike in either: complex128 over 13920 points,
    13824 = 128 x 108 and 16384 among them, runs as two."""
    return product_smem_bytes(n1, n2, 1, itemsize) <= SMEM_LIMIT_BYTES


def pass_tiles(n1: int, n2: int, itemsize: int) -> tuple[int, int]:
    """The two-launch form's tiles: adjacent columns of X per block of the
    column launch and adjacent rows of C per block of the row launch.  The
    FFT body's are ``fft_pass_tiles``; the product body's each a
    power-of-two count of panels (8 ``n_tiles`` wide) whose plane and
    root tables fit half a block's shared memory (two blocks an SM), no
    more than the side needs."""
    if fft_body(n1, n2):
        return fft_pass_tiles(n1, n2, itemsize)
    panel = 8 * n_tiles(n1, n2)
    budget = SMEM_LIMIT_BYTES // 2 - product_smem_bytes(n1, n2, 0, itemsize)

    def tile(side: int, plane) -> int:
        t = panel
        while t < side and plane(2 * t) * itemsize <= budget:
            t *= 2
        return t

    return (tile(n2, lambda t: n1 * plane_pitch(t)),
            tile(n1, lambda t: t * plane_pitch(n2)))


#: Longest signal the kernel takes: 16384 = 128*128 in both dtypes, the
#: reference's (n1, n2 <= 128).  One block holds every split in complex64;
#: in complex128 a split whose plane does not fit (n > 13920, or 13824 =
#: 128*108) runs as two launches through a scratch signal.
MAX_N = {torch.complex64: MAX_FACTOR * MAX_FACTOR,
         torch.complex128: MAX_FACTOR * MAX_FACTOR}


def feasible(n: int, dtype: torch.dtype) -> bool:
    """Does the kernel take a signal of length ``n`` in ``dtype``?  Every
    n = n1*n2 with n1, n2 <= 128, as the reference's rule."""
    try:
        choose_factors(n)
    except ValueError:
        return False
    return True


def check_length(n: int, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` for a length the kernel cannot take."""
    choose_factors(n)


@dataclass(frozen=True)
class Tables:
    """A plan's device state: the split, its W1 (n1 x n1), W2 (n2 x n2)
    and T (n1 x n2) tables (what the plain version reads), and the
    kernel's root vector: the roots of W1 (n1) and of W2 (n2), and T's
    two root tables, w_n^e and w_n^(128 e) for e < 128.  ``inverse`` is
    None when every entry is real (n = 1 or 2: both directions are the
    same)."""

    n1: int
    n2: int
    w1: torch.Tensor
    w2: torch.Tensor
    t: torch.Tensor
    roots: torch.Tensor
    inverse: bool | None

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.w1, self.w2, self.t, self.roots))


def kernel_roots(n1: int, n2: int, inverse: bool, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """The kernel's root vector for the split n1 x n2 (see ``Tables``),
    built in float64 on the host and cast once to ``dtype``."""
    n = n1 * n2
    k = TWIDDLE_ROOTS
    c128 = torch.complex128
    hi = unit_roots(n, k * k, inverse, c128, device="cpu")[::k]
    return torch.cat([unit_roots(n1, n1, inverse, c128, device="cpu"),
                      unit_roots(n2, n2, inverse, c128, device="cpu"),
                      unit_roots(n, k, inverse, c128, device="cpu"), hi]
                     ).to(device=device, dtype=dtype)


def make_tables(n: int, inverse: bool, dtype: torch.dtype,
                device) -> Tables:
    """Build the plan for length ``n`` on ``device``: the reference's split,
    the tables in float64 on the host, cast once to ``dtype`` and
    uploaded."""
    check_length(n, dtype)
    n1, n2 = choose_factors(n)
    return Tables(n1, n2,
                  dft_matrix(n1, inverse, dtype, device=device),
                  dft_matrix(n2, inverse, dtype, device=device),
                  twiddle_grid(n1, n2, inverse, dtype, device=device),
                  kernel_roots(n1, n2, inverse, dtype, device), inverse)


def tables_from_reference(w1r, w1i, w2r, w2i, tr, ti, device) -> Tables:
    """The port's plan from the reference's real/imaginary table planes
    (W1, W2, T, as its ``ops.fft`` hands them to the kernel), with the
    kernel's roots for the planes' direction."""
    dtype = torch.complex128 if w1r.dtype == np.float64 else torch.complex64
    as_c = lambda re, im: torch.complex(torch.from_numpy(np.asarray(re)),
                                        torch.from_numpy(np.asarray(im))
                                        ).to(device=device, dtype=dtype)
    imag = np.concatenate([np.ravel(a) for a in (w1i, w2i, ti)])
    n1, n2 = w1r.shape[0], w2r.shape[0]
    inverse = direction_of(imag)
    return Tables(n1, n2, as_c(w1r, w1i), as_c(w2r, w2i), as_c(tr, ti),
                  kernel_roots(n1, n2, bool(inverse), dtype, device), inverse)


@functools.cache
def _cuda_shape(index: int) -> tuple[int, int]:
    props = torch.cuda.get_device_properties(index)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_multiprocessor", SM_SMEM_BYTES))


def card_shape(device: torch.device | None) -> tuple[int, int]:
    """SMs and shared memory bytes of one SM of ``device``, read from a
    CUDA device's properties; the H100 SXM's (``CARD_SMS``,
    ``SM_SMEM_BYTES``) for None or the CPU."""
    if device is None or device.type != "cuda":
        return CARD_SMS, SM_SMEM_BYTES
    index = device.index
    return _cuda_shape(torch.cuda.current_device() if index is None
                       else index)


def default_tile_b(n1: int, n2: int, batch: int, itemsize: int,
                   device: torch.device | None = None) -> int:
    """Signals per block on ``device`` (``card_shape``): the FFT body's
    ``fft_tile_b``; for the product
    body as many as give each of the block's warps two column-pass items,
    few enough that two blocks share an SM (as the kernel's launch bounds
    plan), at least one, never more than the batch.  (The card's tile
    sweeps at the main path's shapes put the product body's fastest tile
    there or next to it.)"""
    if fft_body(n1, n2):
        return fft_tile_b(n1, n2, batch, itemsize, *card_shape(device))
    fill = -(-2 * WARPS // column_items(n1, n2, itemsize))
    empty = product_smem_bytes(n1, n2, 0, itemsize)
    fit = (SMEM_LIMIT_BYTES // 2 - empty) \
        // (product_smem_bytes(n1, n2, 1, itemsize) - empty)
    return max(1, min(batch, fill, fit))


def plain(x: torch.Tensor, tables: Tables, inverse: bool) -> torch.Tensor:
    """The split's body in plain torch on ``x`` with the plan's own tables,
    normalized as ``fft``: ``ref.apply_fourstep_fft`` for the FFT body,
    ``ref.apply_fourstep`` (and 1/n for the inverse) for the product
    body."""
    n1, n2 = tables.n1, tables.n2
    if fft_body(n1, n2):
        return apply_fourstep_fft(x, tables.roots, n1, n2, inverse)
    y = apply_fourstep(x, tables.w1, tables.w2, tables.t)
    return y / (n1 * n2) if inverse else y


def radix_args(n1: int, n2: int) -> list[int]:
    """The FFT body's radices as the kernel's entry takes them: the n1
    side's three, then the n2 side's, 0 for no pass."""
    pad = lambda r: list(r) + [0] * (MAX_PASSES - len(r))
    return pad(side_radices(n1)) + pad(side_radices(n2))


def fft(x: torch.Tensor, inverse: bool = False, *, tile_b: int | None = None,
        twiddles: Tables | None = None) -> torch.Tensor:
    """Four-step FFT along the last axis.

    Any n = n1*n2 with both factors <= 128 (``MAX_N[dtype]``): one launch
    where a signal's plane fits one block, two (``one_block``) where it
    does not; numpy semantics (the inverse applies 1/n), natural-order
    output.  Real input is cast to complex64.  ``tile_b`` (signals per
    block, one-launch splits only) is the tunable knob; ``twiddles`` is a
    prebuilt plan (``make_tables``) that must match the call's length,
    dtype, device and direction.
    """
    if not x.is_complex():
        x = x.to(torch.complex64)
    if x.dtype not in _CDTYPES:
        raise TypeError(f"fourstep_pallas takes complex64/complex128, got {x.dtype}")
    n = x.shape[-1]
    check_length(n, x.dtype)
    if n == 1:
        return x   # length-1 DFT is the identity (1/n factor is 1 too)
    if twiddles is None:
        twiddles = make_tables(n, inverse, x.dtype, x.device)
    elif (twiddles.n1 * twiddles.n2 != n
          or (twiddles.n1, twiddles.n2) != choose_factors(n)
          or twiddles.t.dtype != x.dtype or twiddles.t.device != x.device
          or twiddles.inverse not in (None, inverse)):
        raise ValueError("tables do not match this call: plan "
                         f"{twiddles.n1}x{twiddles.n2} {twiddles.t.dtype} on "
                         f"{twiddles.t.device} inverse={twiddles.inverse}; "
                         f"call n={n} {x.dtype} on {x.device} "
                         f"inverse={inverse}")
    if x.device.type == "cpu":
        return plain(x, twiddles, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"fourstep_pallas runs on cuda or cpu, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("fourstep_pallas needs a contiguous tensor "
                         "(the transformed axis last, unit stride)")
    return _launch(x, inverse, tile_b, twiddles)


@functools.cache
def _kernel(dtype: torch.dtype):
    """The library's entry point for ``dtype``, its signature set once."""
    lib = _build.library("fft4step")
    fn = lib.fft4step_f64 if dtype == torch.complex128 else lib.fft4step_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fft_kernel(dtype: torch.dtype, passes: bool):
    """The library's FFT-body entry for ``dtype`` (one launch, or the two
    launches), its signature set once."""
    lib = _build.library("fft4step")
    name = "fft4step_fft_passes" if passes else "fft4step_fft"
    fn = getattr(lib, f"{name}_{'f64' if dtype == torch.complex128 else 'f32'}")
    # x, (scratch,) y, tables; batch; n1, n2, the six radices, then tile,
    # pitch and threads (or both launches' tiles and pitches), inverse
    ptrs = 4 if passes else 3
    ints = 2 + 2 * MAX_PASSES + (4 if passes else 3) + 1
    fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_longlong]
                   + [ctypes.c_int] * ints + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _passes_kernel(dtype: torch.dtype):
    """The library's two-launch entry for ``dtype``, its signature set
    once."""
    lib = _build.library("fft4step")
    fn = lib.fft4step_passes_f64 if dtype == torch.complex128 \
        else lib.fft4step_passes_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _run_passes(x: torch.Tensor, y: torch.Tensor, tables: Tables,
                inverse: bool) -> int:
    """The two launches (column DFTs times T into a scratch signal, then
    the row DFTs into ``y``), in the split's body; returns 2.  Counts
    nothing."""
    n1, n2 = tables.n1, tables.n2
    rows = x.numel() // (n1 * n2)
    itemsize = x.element_size()
    tile_cols, tile_rows = pass_tiles(n1, n2, itemsize)
    tmp = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if fft_body(n1, n2):
            err = _fft_kernel(x.dtype, True)(
                x.data_ptr(), tmp.data_ptr(), y.data_ptr(),
                tables.roots.data_ptr(), rows, n1, n2, *radix_args(n1, n2),
                tile_cols, tile_rows, fft_pitch(tile_cols, n1, itemsize),
                fft_pitch(n2, tile_rows, itemsize), int(inverse), stream)
        else:
            err = _passes_kernel(x.dtype)(
                x.data_ptr(), tmp.data_ptr(), y.data_ptr(),
                tables.roots.data_ptr(), rows, n1, n2, tile_cols, tile_rows,
                m_group(n1, n2, itemsize), n_tiles(n1, n2), int(inverse),
                stream)
    if err != 0:
        raise RuntimeError(f"fft4step passes failed: cudaError_t {err} "
                           f"(n={n1 * n2}, rows={rows}, tiles {tile_cols}/"
                           f"{tile_rows}, {x.dtype})")
    return 2


def _launch(x: torch.Tensor, inverse: bool, tile_b: int | None,
            tables: Tables) -> torch.Tensor:
    global LAUNCHES
    n1, n2 = tables.n1, tables.n2
    n = n1 * n2
    rows = x.numel() // n
    y = torch.empty_like(x)
    if rows == 0:
        return y
    itemsize = x.element_size()
    key = (n, rows, str(x.dtype).removeprefix("torch."))
    if not one_block(n1, n2, itemsize):
        if tile_b is not None:
            raise ValueError(f"tile_b={tile_b} does not fit one block for "
                             f"n={n} {x.dtype}: the split runs as two "
                             "launches, which take no batch tile")
        launched = _run_passes(x, y, tables, inverse)
        LAUNCHES += launched
        LAUNCH_SHAPES[key] += launched
        return y
    tile = tile_b if tile_b is not None else default_tile_b(
        n1, n2, rows, itemsize, x.device)
    tile = min(tile, rows)
    if tile < 1 or smem_bytes(n1, n2, tile, itemsize) > SMEM_LIMIT_BYTES:
        raise ValueError(f"tile_b={tile_b} does not fit one block for n={n} "
                         f"{x.dtype} (shared memory limit "
                         f"{SMEM_LIMIT_BYTES} bytes)")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if fft_body(n1, n2):
            err = _fft_kernel(x.dtype, False)(
                x.data_ptr(), y.data_ptr(), tables.roots.data_ptr(), rows,
                n1, n2, *radix_args(n1, n2), tile,
                fft_pitch(n2, tile * n1, itemsize),
                fft_threads(n1, n2, tile, itemsize), int(inverse), stream)
        else:
            err = _kernel(x.dtype)(
                x.data_ptr(), y.data_ptr(), tables.roots.data_ptr(), rows,
                n1, n2, tile, m_group(n1, n2, itemsize), n_tiles(n1, n2),
                int(inverse), stream)
    if err != 0:
        raise RuntimeError(f"fft4step kernel launch failed: cudaError_t {err} "
                           f"(n={n}, rows={rows}, tile_b={tile}, {x.dtype})")
    LAUNCHES += 1
    LAUNCH_SHAPES[key] += 1
    return y
