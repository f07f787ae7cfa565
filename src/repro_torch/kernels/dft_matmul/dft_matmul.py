"""The batched DFT kernel and its launch.

The kernel is CUDA C++ (``repro_torch/csrc/dft.cu``).  It replaces the
reference package's Pallas kernel ``dft_matmul`` (``_dft_kernel``: a tile
of rows of length n <= 128 times the n x n DFT matrix) with two bodies:

* for a 7-smooth n, an FFT held in registers: n = n1 * n2, each warp owns
  a few rows and a private slice of shared memory; a lane runs the n1-point
  FFT of one column of a row (with the twiddle W_n^(j2 k1)), the warp
  exchanges through its slice, and a lane runs the n2-point FFT of one row
  of the slice and stores it in natural order.  The twiddles come from one
  table of the n forward roots (host float64, cast once); the inverse
  conjugates on load and store;
* for any other n, the direct product: each thread computes a 4 x 4
  register tile of outputs, reading W from global memory, with fp32 FMA
  for complex64 and fp64 for complex128 on the CUDA cores.

This module keeps the launch's host side: the cap, the split, the warps'
rows and slice layout, the register tile and the shared-memory size of
one block.
"""

from __future__ import annotations

import functools

import numpy as np

#: Longest row the kernel takes (both dtypes): the reference's n <= 128.
MAX_N = 128

#: Threads of one direct-body block (``kThreads`` in the kernel).
THREADS = 256

#: Outputs per thread along each axis of the direct product (``kRT``).
REGISTER_TILE = 4

#: Warps of one FFT-body block (``kFftWarps``).
FFT_WARPS = 4

#: Lengths of the FFTs a lane holds in registers (``DFT_FFT_SIZES``).
FFT_SIZES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 15, 16, 25)

#: Shared memory of one warp's slice at most (rows of n1 x (n2 + 1)
#: points), so that a block of four warps leaves room for several on an SM.
SLICE_BYTES = 6 << 10


def fft_split(n: int) -> tuple[int, int]:
    """The FFT body's split n = n1 * n2 of a 7-smooth n <= 128: both
    factors register-FFT sizes, the larger as small as it can be, n1 <= n2
    (the loads are runs of n2 points, the stores runs of n1)."""
    pairs = [(n1, n // n1) for n1 in FFT_SIZES
             if n % n1 == 0 and n // n1 in FFT_SIZES and n1 <= n // n1]
    if not pairs:
        raise ValueError(f"n={n} has no split into register-FFT sizes")
    return min(pairs, key=lambda p: (p[1], -p[0]))


def smem_bytes(n: int, tile_b: int, itemsize: int) -> int:
    """Dynamic shared memory of one direct-body block: its ``tile_b``
    rows."""
    return tile_b * n * itemsize


def fill_rows(n: int) -> int:
    """Rows that give each of a direct-body block's threads one register
    tile."""
    col_groups = -(-n // REGISTER_TILE)
    return max(1, THREADS // col_groups) * REGISTER_TILE


def _wavefronts(addr: np.ndarray, words: int) -> int:
    """Shared-memory wavefronts of one warp access: the most distinct
    4-byte words any of the 32 banks serves."""
    w = (addr[:, None] * words + np.arange(words)).ravel()
    w = np.unique(w)
    return int(np.bincount(w % 32, minlength=32).max())


@functools.cache
def slice_layout(n1: int, n2: int, rpw: int, itemsize: int
                 ) -> tuple[int, int]:
    """(pitch, row stride) of a warp's slice, in points: element (r, k1,
    j2) at r*rs + k1*pitch + j2, padded so that pass 1's stores (lanes on
    (r, j2), one k1 at a time) and pass 2's loads (lanes on (r, k1), one
    j2 at a time) take the fewest wavefronts; the smallest slice of
    those."""
    words = itemsize // 4
    best = None
    for pitch in range(n2, n2 + 9):
        for rs in range(n1 * pitch, n1 * pitch + 9):
            cost = 0
            for width, depth, lane_addr in (
                    (n2, n1, lambda r, c: r * rs + c),          # (r, j2)
                    (n1, n2, lambda r, c: r * rs + c * pitch)):  # (r, k1)
                tasks = np.arange(rpw * width)
                for start in range(0, tasks.size, 32):
                    t = tasks[start:start + 32]
                    base = lane_addr(t // width, t % width)
                    step = pitch if width == n2 else 1
                    for d in range(depth):
                        cost += _wavefronts(base + d * step, words)
            key = (cost, rpw * rs)
            if best is None or key < best[0]:
                best = (key, pitch, rs)
    return best[1], best[2]


@functools.cache
def rows_per_warp(n1: int, n2: int, itemsize: int) -> int:
    """Rows a warp owns by default: the fewest task rounds a row (both
    passes' tasks over 32 lanes), within ``SLICE_BYTES``; the fewest rows
    of those."""
    best = None
    for rpw in range(1, 33):
        if rpw > 1 and rpw * n1 * (n2 + 1) * itemsize > SLICE_BYTES:
            break
        rounds = (-(-rpw * n2 // 32) + -(-rpw * n1 // 32)) / rpw
        if best is None or rounds < best[0] - 1e-12:
            best = (rounds, rpw)
    return best[1] if best else 1


def fft_geometry(n: int, tile_b: int, itemsize: int
                 ) -> tuple[int, int, int, int, int]:
    """(n1, n2, rows per warp, pitch, row stride) of an FFT-body launch
    of ``tile_b`` rows per block."""
    n1, n2 = fft_split(n)
    rpw = -(-tile_b // FFT_WARPS)
    pitch, rs = slice_layout(n1, n2, rpw, itemsize)
    return n1, n2, rpw, pitch, rs


def fft_smem_bytes(n: int, tile_b: int, itemsize: int) -> int:
    """Dynamic shared memory of one FFT-body block: its warps' slices."""
    _, _, rpw, _, rs = fft_geometry(n, tile_b, itemsize)
    return FFT_WARPS * rpw * rs * itemsize


def fft_tile_b(n: int, itemsize: int) -> int:
    """The FFT body's default rows per block: ``rows_per_warp`` rows for
    each of its warps."""
    n1, n2 = fft_split(n)
    return FFT_WARPS * rows_per_warp(n1, n2, itemsize)
