"""Public wrapper of the batched DFT kernel: the plan's table (host
float64, cast once to the plane dtype), the body and its launch geometry,
normalization.

``dft`` launches the CUDA kernel (``repro_torch/csrc/dft.cu``, the
counterpart of the reference's Pallas ``dft_matmul``) for a tensor on the
card: for a 7-smooth n its FFT body (two passes of FFTs in registers over
the table of n roots), for any other n its chirp body (the chirp-z
convolution at a length m >= 2n - 1, four passes of FFTs in registers
over the m roots, the chirp and the filter spectrum).  Both are bounded
by one read and one write of the rows.  It takes the plain version
(``ref.apply_fft`` or ``ref.apply_chirp``) only for a tensor on the CPU.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass

import torch

from .. import _build
from ...fft.bluestein import chirp_tables
from ...fft.reference import unit_roots
from ..stockham_pallas.ops import SMEM_LIMIT_BYTES
from ..stockham_pallas.stockham_pallas import smooth7
from .dft_matmul import (FFT_WARPS, MAX_N, chirp_split, fft_geometry,
                         fft_smem_bytes, fft_split, fft_tile_b)
from .ref import apply_chirp, apply_fft

_CDTYPES = (torch.complex64, torch.complex128)

#: Kernel launches, and launches by (n, rows, dtype); the wrapper adds to
#: both where it launches the kernel and nowhere else.
LAUNCHES = 0
LAUNCH_SHAPES: Counter = Counter()


def check_length(n: int) -> None:
    """Raise ``ValueError`` for a length the kernel cannot take."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"dft caps at n={MAX_N} (the reference's one n x n "
                         f"product per row); got {n}")


@dataclass(frozen=True)
class Matrix:
    """A plan's device state, one table for both directions (the inverse
    conjugates), so ``inverse`` is None.  For a 7-smooth n (the FFT body)
    the n forward roots W_n^e; for any other n (the chirp body, ``m`` its
    convolution length) the m roots W_m^e, the n chirp values c[j] =
    W_2n^(j^2) and the m values of the filter spectrum fft(conj c) / m, in
    that order."""

    n: int
    w: torch.Tensor
    inverse: bool | None = None
    m: int = 0

    @property
    def fft(self) -> bool:
        """Does the plan run the FFT body (else the chirp body)?"""
        return self.m == 0

    @property
    def roots(self) -> torch.Tensor:
        return self.w[:self.m or self.n]

    @property
    def chirp(self) -> torch.Tensor:
        return self.w[self.m:self.m + self.n]

    @property
    def spectrum(self) -> torch.Tensor:
        return self.w[self.m + self.n:]

    @property
    def nbytes(self) -> int:
        return self.w.numel() * self.w.element_size()


def make_matrix(n: int, inverse: bool, dtype: torch.dtype,
                device) -> Matrix:
    """Build the plan for length ``n`` on ``device`` (either direction:
    ``inverse`` does not change it): the table in float64 on the host,
    cast once to ``dtype`` and uploaded."""
    check_length(n)
    if smooth7(n):
        return Matrix(n, unit_roots(n, n, False, dtype, device=device))
    m1, m2 = chirp_split(n)
    return Matrix(n, chirp_table(n, m1 * m2, dtype, device), m=m1 * m2)


def chirp_table(n: int, m: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The chirp body's table for length ``n`` at convolution length
    ``m``: the m roots, the n chirp values and the m spectrum values over
    m, in float64 on the host, cast once to ``dtype`` and uploaded."""
    c, fb = chirp_tables(n, m, torch.complex128)
    w = torch.cat([unit_roots(m, m, False, torch.complex128, device="cpu"),
                   torch.from_numpy(c), torch.from_numpy(fb / m)])
    return w.to(device=device, dtype=dtype)


def default_tile_b(n: int, rows: int, itemsize: int) -> int:
    """Rows per block: the body's warps' default rows, never more than the
    batch."""
    return max(1, min(rows, fft_tile_b(n, itemsize)))


def plain(x: torch.Tensor, matrix: Matrix, inverse: bool) -> torch.Tensor:
    """The kernel's arithmetic under ``matrix`` in plain torch, on any
    device, normalized as ``dft`` (the inverse applies 1/n)."""
    if matrix.fft:
        return apply_fft(x, matrix.w, *fft_split(matrix.n), inverse)
    return apply_chirp(x, matrix.roots, matrix.chirp, matrix.spectrum,
                       *chirp_split(matrix.n), inverse)


def dft(x: torch.Tensor, inverse: bool = False, *, tile_b: int | None = None,
        matrix: Matrix | None = None) -> torch.Tensor:
    """DFT along the last axis, n <= 128.

    Numpy semantics (forward unnormalized, the inverse applies 1/n); any
    batch shape.  Real input is cast to complex64 at any width, as the
    reference's ``ops.dft`` does.  ``tile_b`` (rows per block) is the
    tunable knob; ``matrix`` is a prebuilt plan (``make_matrix``) that
    must match the call's length, dtype and device.
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
          or matrix.w.device != x.device or matrix.fft != smooth7(n)):
        raise ValueError("table does not match this call: plan "
                         f"n={matrix.n} {matrix.w.dtype} on {matrix.w.device} "
                         f"({'FFT' if matrix.fft else 'chirp'} body); call "
                         f"n={n} {x.dtype} on {x.device}")
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
    once (the same for both bodies)."""
    lib = _build.library("dft")
    body = "fft" if fft else "chirp"
    bits = 64 if dtype == torch.complex128 else 32
    fn = getattr(lib, f"dft_{body}_f{bits}")
    c = ctypes
    fn.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p, c.c_longlong,
                   c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
                   c.c_int, c.c_int, c.c_void_p]
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
    if tile > 32 * FFT_WARPS:     # more than 32 rows a warp
        need = SMEM_LIMIT_BYTES + 1
    else:
        need = fft_smem_bytes(n, tile, itemsize)
    if tile < 1 or need > SMEM_LIMIT_BYTES:
        raise ValueError(f"tile_b={tile_b} does not fit one block for n={n} "
                         f"{x.dtype} (shared memory limit "
                         f"{SMEM_LIMIT_BYTES} bytes)")
    fn = _kernel(x.dtype, matrix.fft)
    n1, n2, rpw, pitch, rs = fft_geometry(n, tile, itemsize)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), matrix.w.data_ptr(), rows, n,
                 n1, n2, tile, rpw, pitch, rs, int(inverse), stream)
    if err != 0:
        raise RuntimeError(f"dft kernel launch failed: cudaError_t {err} "
                           f"(n={n}, rows={rows}, tile_b={tile}, {x.dtype})")
    LAUNCHES += 1
    LAUNCH_SHAPES[(n, rows, str(x.dtype).removeprefix("torch."))] += 1
    return y
