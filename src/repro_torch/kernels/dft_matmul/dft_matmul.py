"""The batched DFT kernel and its launch.

The kernel is CUDA C++ (``repro_torch/csrc/dft.cu``).  It replaces the
reference package's Pallas kernel ``dft_matmul`` (``_dft_kernel``: a tile
of rows of length n <= 128 times the n x n DFT matrix).  The direct
product does 8n flops a point, about 3x the card's fp32 flop-per-byte
ridge at n = 127, so both of the kernel's bodies are FFTs held in
registers, bounded by one read and one write of the rows.  Each warp owns
a few rows and a private slice of shared memory; a lane runs the n1-point
FFT of one column of a row (with a twiddle), the warp exchanges through
its slice, and a lane runs the n2-point FFT of one row of the slice:

* for a 7-smooth n, the FFT body: n = n1 * n2 (``fft_split``), twiddles
  from one table of the n forward roots;
* for any other n, the chirp body: the chirp-z identity turns the row
  into a circular convolution at a length m = m1 * m2 >= 2n - 1
  (``chirp_split``), run as four register passes (the forward FFT of the
  chirped row, the product with the filter spectrum, the inverse FFT)
  with two exchanges.

Every table is built in float64 on the host and cast once; the inverse
conjugates on load and store.  This module keeps the launch's host side:
the cap, the splits, the warps' rows and slice layout and the
shared-memory size of one block.
"""

from __future__ import annotations

import functools

import numpy as np

from ..stockham_pallas.stockham_pallas import smooth7

#: Longest row the kernel takes (both dtypes): the reference's n <= 128.
MAX_N = 128

#: Warps of one block of either body (``kFftWarps``).
FFT_WARPS = 4

#: Lengths of the FFTs a lane holds in registers (``DFT_FFT_SIZES``).
FFT_SIZES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 15, 16, 25)

#: Shared memory of one warp's slice at most (rows of n1 x (n2 + 1)
#: points), so that a block of four warps leaves room for several on an SM.
SLICE_BYTES = 6 << 10

#: Real flops of one r-point butterfly of the kernel
#: (``stockham_stages.cuh``): radix 2, 4 and 8 by adds (and radix 8's
#: two rot8, 4 flops each), the odd radices by their paired outputs.
BUTTERFLY_FLOPS = {2: 4, 3: 18, 4: 16, 5: 52, 7: 102, 8: 56}

#: The chirp body's register-FFT sizes (25 is left to the FFT body's
#: n = 125: 16 x 16 covers every chirp length, with fewer registers).
CHIRP_SIZES = (2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 15, 16)

#: Points a warp of the chirp body holds (rows per warp = this over m):
#: the fastest tile on the card at m = 40, 64 and 256 (PERF.md).
CHIRP_WARP_POINTS = 512


def fft_split(n: int) -> tuple[int, int]:
    """The FFT body's split n = n1 * n2 of a 7-smooth n <= 128: both
    factors register-FFT sizes, the larger as small as it can be, n1 <= n2
    (the loads are runs of n2 points, the stores runs of n1)."""
    pairs = [(n1, n // n1) for n1 in FFT_SIZES
             if n % n1 == 0 and n // n1 in FFT_SIZES and n1 <= n // n1]
    if not pairs:
        raise ValueError(f"n={n} has no split into register-FFT sizes")
    return min(pairs, key=lambda p: (p[1], -p[0]))


@functools.cache
def reg_fft_flops(m: int) -> int:
    """Real flops of the kernel's m-point register FFT (``RegFft``): a
    radix-r DIF step (m/r butterflies, the twiddles on (r-1)(m/r-1)
    outputs, 6 flops each), then the r sub-FFTs of m/r points."""
    if m == 1:
        return 0
    r = m if m in BUTTERFLY_FLOPS else next(r for r in (4, 2, 3, 5)
                                            if m % r == 0)
    q = m // r
    return q * BUTTERFLY_FLOPS[r] + 6 * (r - 1) * (q - 1) + r * reg_fft_flops(q)


def chirp_flops(m1: int, m2: int) -> int:
    """Real flops of the chirp body's work on one row that do not depend on
    n: two m-point FFTs (m2 FFTs of m1 points, m1 of m2, the twiddles
    between them) and the spectrum product."""
    fft = (m2 * reg_fft_flops(m1) + m1 * reg_fft_flops(m2)
           + 6 * (m1 - 1) * (m2 - 1))
    return 2 * fft + 6 * m1 * m2


@functools.cache
def chirp_split(n: int) -> tuple[int, int]:
    """The chirp body's split m = m1 * m2 >= 2n - 1 of its convolution
    length, both factors in ``CHIRP_SIZES``, m1 <= m2: the fewest flops
    (``chirp_flops``), the smaller m on a tie.  Not the smallest m: a
    radix-7, 9 or 15 pass costs 2-3x the flops a point of a radix-4, 8 or
    16 one, and the card's times follow the flops (PERF.md: n = 67 at
    12 x 12 against 9 x 15 = 135, n = 11 at 3 x 8 against 3 x 7)."""
    check = [(a, b) for a in CHIRP_SIZES for b in CHIRP_SIZES
             if a <= b and a * b >= 2 * n - 1]
    if not check:
        raise ValueError(f"n={n} is over the chirp body's cap of {MAX_N}")
    return min(check, key=lambda p: (chirp_flops(*p), p[0] * p[1]))


def chirp_rows_per_warp(n: int) -> int:
    """Rows a warp of the chirp body owns by default:
    ``CHIRP_WARP_POINTS`` over its m, 1 to 32."""
    m1, m2 = chirp_split(n)
    return max(1, min(32, CHIRP_WARP_POINTS // (m1 * m2)))


def split(n: int) -> tuple[int, int]:
    """The split of a length-n row's body: n = n1 * n2 for a 7-smooth n
    (the FFT body), m = m1 * m2 >= 2n - 1 for any other (the chirp
    body)."""
    return fft_split(n) if smooth7(n) else chirp_split(n)


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
    """Rows a warp of the FFT body owns by default: the fewest task rounds
    a row (both passes' tasks over 32 lanes), within ``SLICE_BYTES``; the
    fewest rows of those."""
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
    """(n1, n2, rows per warp, pitch, row stride) of a launch of
    ``tile_b`` rows per block: n1, n2 are ``split(n)``, the FFT body's
    factors of n or the chirp body's of m."""
    n1, n2 = split(n)
    rpw = -(-tile_b // FFT_WARPS)
    pitch, rs = slice_layout(n1, n2, rpw, itemsize)
    return n1, n2, rpw, pitch, rs


def fft_smem_bytes(n: int, tile_b: int, itemsize: int) -> int:
    """Dynamic shared memory of one block: its warps' slices, and for the
    chirp body each warp's staged rows (n points a row)."""
    _, _, rpw, _, rs = fft_geometry(n, tile_b, itemsize)
    stage = 0 if smooth7(n) else n
    return FFT_WARPS * rpw * (rs + stage) * itemsize


def fft_tile_b(n: int, itemsize: int) -> int:
    """The default rows per block: ``rows_per_warp`` (the FFT body) or
    ``chirp_rows_per_warp`` (the chirp body) rows for each of its
    warps."""
    if not smooth7(n):
        return FFT_WARPS * chirp_rows_per_warp(n)
    return FFT_WARPS * rows_per_warp(*fft_split(n), itemsize)
