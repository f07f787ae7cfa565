"""Public wrapper of the batched DFT kernel: the plan's table (host
float64, cast once to the plane dtype), the body and its launch geometry,
normalization.

``dft`` launches the CUDA kernel (``repro_torch/csrc/dft.cu``) for a
tensor on the card: for a 7-smooth n its FFT body (two passes of FFTs in
registers over the table of n roots), for any other n its direct product
(the n x n table).  It takes the plain version (``ref.apply_fft`` or
``ref.apply_dft``) only for a tensor on the CPU.  ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass

import torch

from .. import _build
from ...fft.reference import dft_matrix, unit_roots
from ..stockham_pallas.ops import SMEM_LIMIT_BYTES
from ..stockham_pallas.stockham_pallas import smooth7
from .dft_matmul import (FFT_WARPS, MAX_N, fft_geometry, fft_smem_bytes,
                         fft_split, fft_tile_b, fill_rows, smem_bytes)
from .ref import apply_dft, apply_fft

_CDTYPES = (torch.complex64, torch.complex128)

#: Kernel launches, and launches by (n, rows, dtype); the wrapper adds to
#: both where it launches the kernel and nowhere else.
LAUNCHES = 0
LAUNCH_SHAPES: Counter = Counter()


def check_length(n: int) -> None:
    """Raise ``ValueError`` for a length the kernel cannot take."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"dft caps at n={MAX_N} (one n x n product per "
                         f"row); got {n}")


@dataclass(frozen=True)
class Matrix:
    """A plan's device state.  For a 7-smooth n (the FFT body) the n
    forward roots W_n^e, e < n: one table serves both directions (the
    inverse conjugates), so ``inverse`` is None.  For any other n (the
    direct product) the n x n DFT table of its direction."""

    n: int
    w: torch.Tensor
    inverse: bool | None

    @property
    def fft(self) -> bool:
        """Does the plan run the FFT body (a table of roots)?"""
        return self.w.dim() == 1

    @property
    def nbytes(self) -> int:
        return self.w.numel() * self.w.element_size()


def make_matrix(n: int, inverse: bool, dtype: torch.dtype,
                device) -> Matrix:
    """Build the plan for length ``n`` on ``device``: the table in float64
    on the host, cast once to ``dtype`` and uploaded."""
    check_length(n)
    if smooth7(n):
        return Matrix(n, unit_roots(n, n, False, dtype, device=device), None)
    return Matrix(n, dft_matrix(n, inverse, dtype, device=device), inverse)


def default_tile_b(n: int, rows: int, itemsize: int) -> int:
    """Rows per block: for the FFT body, its warps' default rows; for the
    direct product, as many as give every thread a register tile within
    the shared-memory limit; never more than the batch."""
    if smooth7(n):
        return max(1, min(rows, fft_tile_b(n, itemsize)))
    fit = SMEM_LIMIT_BYTES // smem_bytes(n, 1, itemsize)
    return max(1, min(rows, fill_rows(n), fit))


def plain(x: torch.Tensor, matrix: Matrix, inverse: bool) -> torch.Tensor:
    """The kernel's arithmetic under ``matrix`` in plain torch, on any
    device, normalized as ``dft`` (the inverse applies 1/n)."""
    if matrix.fft:
        return apply_fft(x, matrix.w, *fft_split(matrix.n), inverse)
    y = apply_dft(x, matrix.w)
    return y / matrix.n if inverse else y


def dft(x: torch.Tensor, inverse: bool = False, *, tile_b: int | None = None,
        matrix: Matrix | None = None) -> torch.Tensor:
    """DFT along the last axis, n <= 128.

    Numpy semantics (forward unnormalized, the inverse applies 1/n); any
    batch shape.  Real input is cast to complex64 at any width, as the
    reference's ``ops.dft`` does.  ``tile_b`` (rows per block) is the
    tunable knob; ``matrix`` is a prebuilt plan (``make_matrix``) that
    must match the call's length, dtype, device and direction.
    """
    if not x.is_complex():
        x = x.to(torch.complex64)
    if x.dtype not in _CDTYPES:
        raise TypeError(f"dft takes complex64/complex128, got {x.dtype}")
    n = x.shape[-1]
    check_length(n)
    if matrix is None:
        matrix = make_matrix(n, inverse, x.dtype, x.device)
    elif (matrix.n != n or matrix.w.dtype != x.dtype
          or matrix.w.device != x.device
          or matrix.inverse not in (None, inverse)
          or matrix.fft != smooth7(n)):
        raise ValueError("table does not match this call: plan "
                         f"n={matrix.n} {matrix.w.dtype} on {matrix.w.device} "
                         f"inverse={matrix.inverse}; call n={n} {x.dtype} on "
                         f"{x.device} inverse={inverse}")
    if x.device.type == "cpu":
        return plain(x, matrix, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"dft runs on cuda or cpu, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("dft needs a contiguous tensor (the transformed "
                         "axis last, unit stride)")
    return _launch(x, inverse, tile_b, matrix)


@functools.cache
def _kernel(dtype: torch.dtype, fft: bool):
    """The library's entry point for ``dtype`` and body, its signature set
    once."""
    lib = _build.library("dft")
    c = ctypes
    if fft:
        fn = lib.dft_fft_f64 if dtype == torch.complex128 else lib.dft_fft_f32
        fn.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p, c.c_longlong,
                       c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
                       c.c_int, c.c_int, c.c_void_p]
    else:
        fn = lib.dft_f64 if dtype == torch.complex128 else lib.dft_f32
        fn.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p, c.c_longlong,
                       c.c_int, c.c_int, c.c_int, c.c_void_p]
    fn.restype = c.c_int
    return fn


def _launch(x: torch.Tensor, inverse: bool, tile_b: int | None,
            matrix: Matrix) -> torch.Tensor:
    global LAUNCHES
    n = matrix.n
    rows = x.numel() // n
    y = torch.empty_like(x)
    if rows == 0:
        return y
    itemsize = x.element_size()
    tile = tile_b if tile_b is not None else default_tile_b(n, rows, itemsize)
    tile = min(tile, rows)
    if not matrix.fft:
        need = smem_bytes(n, tile, itemsize)
    elif tile > 32 * FFT_WARPS:     # more than 32 rows a warp
        need = SMEM_LIMIT_BYTES + 1
    else:
        need = fft_smem_bytes(n, tile, itemsize)
    if tile < 1 or need > SMEM_LIMIT_BYTES:
        raise ValueError(f"tile_b={tile_b} does not fit one block for n={n} "
                         f"{x.dtype} (shared memory limit "
                         f"{SMEM_LIMIT_BYTES} bytes)")
    fn = _kernel(x.dtype, matrix.fft)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if matrix.fft:
            n1, n2, rpw, pitch, rs = fft_geometry(n, tile, itemsize)
            err = fn(x.data_ptr(), y.data_ptr(), matrix.w.data_ptr(), rows, n,
                     n1, n2, tile, rpw, pitch, rs, int(inverse), stream)
        else:
            err = fn(x.data_ptr(), y.data_ptr(), matrix.w.data_ptr(), rows, n,
                     tile, int(inverse), stream)
    if err != 0:
        raise RuntimeError(f"dft kernel launch failed: cudaError_t {err} "
                           f"(n={n}, rows={rows}, tile_b={tile}, {x.dtype})")
    LAUNCHES += 1
    LAUNCH_SHAPES[(n, rows, str(x.dtype).removeprefix("torch."))] += 1
    return y
