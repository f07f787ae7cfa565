"""Public wrapper of the fused four-step kernel: factor choice, the W1, W2
and T tables (host float64, cast once to the plane dtype), shared-memory
sizing, launch, normalization.

``fft`` launches the CUDA kernel (``repro_torch/csrc/fft4step.cu``) for a
tensor on the card and takes the plain version (``ref.apply_fourstep``)
only for a tensor on the CPU.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ...fft.reference import dft_matrix, twiddles as twiddle_grid
from ..stockham_pallas.ops import SMEM_LIMIT_BYTES, direction_of
from .fft4step import (THREADS, choose_factors, register_tile, smem_bytes,
                       threads_per_signal)
from .ref import apply_fourstep

_CDTYPES = (torch.complex64, torch.complex128)

#: Kernel launches, and launches by (n, rows, dtype); the wrapper adds to
#: both where it launches the kernel and nowhere else.
LAUNCHES = 0
LAUNCH_SHAPES: Counter = Counter()


def _fits(n: int, itemsize: int) -> bool:
    try:
        n1, n2 = choose_factors(n)
    except ValueError:
        return False
    return smem_bytes(n1, n2, 1, itemsize) <= SMEM_LIMIT_BYTES


def _largest_fitting(itemsize: int) -> int:
    return next(n for n in range(128 * 128, 0, -1) if _fits(n, itemsize))


#: Longest signal one block holds (tile_b = 1: the signal and its padded
#: column DFTs in shared memory): 14464 = 128*113 for complex64 and
#: 7216 = 88*82 for complex128.  A longer factorable n is not this
#: kernel's.
MAX_N = {torch.complex64: _largest_fitting(8),
         torch.complex128: _largest_fitting(16)}


def feasible(n: int, dtype: torch.dtype) -> bool:
    """Does the kernel take a signal of length ``n`` in ``dtype``?"""
    return _fits(n, 16 if dtype == torch.complex128 else 8)


def check_length(n: int, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` for a length the kernel cannot take."""
    choose_factors(n)
    if not feasible(n, dtype):
        raise ValueError(f"fourstep_pallas caps at n={MAX_N[dtype]} for "
                         f"{dtype} (Hopper shared memory per block); got {n}")


@dataclass(frozen=True)
class Tables:
    """A plan's device state: the split and its W1 (n1 x n1), W2 (n2 x n2)
    and T (n1 x n2) tables.  ``inverse`` is None when every entry is real
    (n = 1 or 2: both directions are the same)."""

    n1: int
    n2: int
    w1: torch.Tensor
    w2: torch.Tensor
    t: torch.Tensor
    inverse: bool | None

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.w1, self.w2, self.t))


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
                  twiddle_grid(n1, n2, inverse, dtype, device=device), inverse)


def tables_from_reference(w1r, w1i, w2r, w2i, tr, ti, device) -> Tables:
    """The port's plan from the reference's real/imaginary table planes
    (W1, W2, T, as its ``ops.fft`` hands them to the kernel)."""
    dtype = torch.complex128 if w1r.dtype == np.float64 else torch.complex64
    as_c = lambda re, im: torch.complex(torch.from_numpy(np.asarray(re)),
                                        torch.from_numpy(np.asarray(im))
                                        ).to(device=device, dtype=dtype)
    imag = np.concatenate([np.ravel(a) for a in (w1i, w2i, ti)])
    return Tables(w1r.shape[0], w2r.shape[0], as_c(w1r, w1i), as_c(w2r, w2i),
                  as_c(tr, ti), direction_of(imag))


def default_tile_b(n1: int, n2: int, batch: int, itemsize: int) -> int:
    """Signals per block: as many as keep the block's threads busy (at
    least one), within the shared-memory limit, never more than the
    batch."""
    fill = THREADS // threads_per_signal(n1, n2)
    fit = SMEM_LIMIT_BYTES // smem_bytes(n1, n2, 1, itemsize)
    return max(1, min(batch, fill, fit))


def fft(x: torch.Tensor, inverse: bool = False, *, tile_b: int | None = None,
        twiddles: Tables | None = None) -> torch.Tensor:
    """Four-step FFT along the last axis.

    Any n = n1*n2 with both factors <= 128 that fits one block
    (``MAX_N[dtype]``); numpy semantics (the inverse applies 1/n),
    natural-order output.  Real input is cast to complex64.  ``tile_b`` is
    the tunable knob; ``twiddles`` is a prebuilt plan (``make_tables``)
    that must match the call's length, dtype, device and direction.
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
        y = apply_fourstep(x, twiddles.w1, twiddles.w2, twiddles.t)
        return y / n if inverse else y
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
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    tile = tile_b if tile_b is not None else default_tile_b(n1, n2, rows,
                                                            itemsize)
    tile = min(tile, rows)
    if tile < 1 or smem_bytes(n1, n2, tile, itemsize) > SMEM_LIMIT_BYTES:
        raise ValueError(f"tile_b={tile_b} does not fit one block for n={n} "
                         f"{x.dtype} (shared memory limit "
                         f"{SMEM_LIMIT_BYTES} bytes)")
    fn = _kernel(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), tables.w1.data_ptr(),
                 tables.w2.data_ptr(), tables.t.data_ptr(), rows, n1, n2,
                 tile, register_tile(n), int(inverse), stream)
    if err != 0:
        raise RuntimeError(f"fft4step kernel launch failed: cudaError_t {err} "
                           f"(n={n}, rows={rows}, tile_b={tile}, {x.dtype})")
    LAUNCHES += 1
    LAUNCH_SHAPES[(n, rows, str(x.dtype).removeprefix("torch."))] += 1
    return y
