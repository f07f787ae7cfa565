"""Public wrapper of the batched direct DFT kernel: the DFT table (host
float64, cast once to the plane dtype), tile choice, launch,
normalization.

``dft`` launches the CUDA kernel (``repro_torch/csrc/dft.cu``) for a
tensor on the card and takes the plain version (``ref.apply_dft``) only
for a tensor on the CPU.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass

import torch

from .. import _build
from ...fft.reference import dft_matrix
from ..stockham_pallas.ops import SMEM_LIMIT_BYTES
from .dft_matmul import MAX_N, fill_rows, smem_bytes
from .ref import apply_dft

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
    """A plan's device state: the n x n DFT table.  ``inverse`` is None
    when every entry is real (n <= 2: both directions are the same)."""

    n: int
    w: torch.Tensor
    inverse: bool | None

    @property
    def nbytes(self) -> int:
        return self.w.numel() * self.w.element_size()


def make_matrix(n: int, inverse: bool, dtype: torch.dtype,
                device) -> Matrix:
    """Build the plan for length ``n`` on ``device``: the table in float64
    on the host, cast once to ``dtype`` and uploaded."""
    check_length(n)
    return Matrix(n, dft_matrix(n, inverse, dtype, device=device),
                  None if n <= 2 else inverse)


def default_tile_b(n: int, rows: int, itemsize: int) -> int:
    """Rows per block: as many as give every thread a register tile, within
    the shared-memory limit, never more than the batch."""
    fit = SMEM_LIMIT_BYTES // smem_bytes(n, 1, itemsize)
    return max(1, min(rows, fill_rows(n), fit))


def dft(x: torch.Tensor, inverse: bool = False, *, tile_b: int | None = None,
        matrix: Matrix | None = None) -> torch.Tensor:
    """Direct DFT along the last axis, n <= 128.

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
          or matrix.inverse not in (None, inverse)):
        raise ValueError("table does not match this call: plan "
                         f"n={matrix.n} {matrix.w.dtype} on {matrix.w.device} "
                         f"inverse={matrix.inverse}; call n={n} {x.dtype} on "
                         f"{x.device} inverse={inverse}")
    if x.device.type == "cpu":
        y = apply_dft(x, matrix.w)
        return y / n if inverse else y
    if x.device.type != "cuda":
        raise ValueError(f"dft runs on cuda or cpu, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("dft needs a contiguous tensor (the transformed "
                         "axis last, unit stride)")
    return _launch(x, inverse, tile_b, matrix)


@functools.cache
def _kernel(dtype: torch.dtype):
    """The library's entry point for ``dtype``, its signature set once."""
    lib = _build.library("dft")
    fn = lib.dft_f64 if dtype == torch.complex128 else lib.dft_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
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
    if tile < 1 or smem_bytes(n, tile, itemsize) > SMEM_LIMIT_BYTES:
        raise ValueError(f"tile_b={tile_b} does not fit one block for n={n} "
                         f"{x.dtype} (shared memory limit "
                         f"{SMEM_LIMIT_BYTES} bytes)")
    fn = _kernel(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), matrix.w.data_ptr(), rows, n,
                 tile, int(inverse), stream)
    if err != 0:
        raise RuntimeError(f"dft kernel launch failed: cudaError_t {err} "
                           f"(n={n}, rows={rows}, tile_b={tile}, {x.dtype})")
    LAUNCHES += 1
    LAUNCH_SHAPES[(n, rows, str(x.dtype).removeprefix("torch."))] += 1
    return y
