"""The fused four-step FFT kernel and its launch.

The kernel is CUDA C++ (``repro_torch/csrc/fft4step.cu``).  It replaces
the reference package's Pallas kernel ``fft4step`` (``_fft4step_kernel``):
for a tile of signals of length n = n1*n2 it computes the column DFTs of
length n1, the twiddle multiply by T and the row DFTs of length n2 on
chip, and writes the (n2, n1) transpose, which read flat is the
natural-order spectrum.  It has two bodies, chosen by the split
(``fft_body``):

* the FFT body, where both sides are 7-smooth: each side's DFTs run as
  one to three register passes of radix at most 16 (``side_radices``)
  over a shared-memory plane, FFTs held in registers (``csrc/
  reg_fft.cuh``), about 5 log2(n) flops a point, so the bytes bound it;
* the product body, where a side is not (such as 19 x 19): both DFTs as
  dense products on the tensor cores through ``mma.sync``
  (``csrc/tc_product.cuh``): 3xTF32 for complex64 (each fp32 operand
  split into a TF32 high part and remainder, three products summed in
  fp32, which keeps the suite's accuracy bar that plain TF32 breaks),
  fp64 for complex128.

Each signal lives in one shared-memory plane, computed in place; W1, W2
and T come from small root tables.  A complex128 signal whose plane one
block does not hold (13824, 16384) runs as two launches: the column DFTs
times T into a scratch signal, then the row DFTs, each block holding a
tile of columns or rows.

This module keeps the launch's host side: the factor choice (the
reference's, exactly), the FFT body's passes, pitch and tiles, the
product body's warp groups, the two-launch tiles, and the shared-memory
size of one block.
"""

from __future__ import annotations

import functools

from ..dft_matmul.dft_matmul import reg_fft_flops
from ..stockham_pallas.block import SMEM_LIMIT_BYTES
from ..stockham_pallas.stockham_pallas import smooth7

#: Largest factor of the split: both n1 and n2 are at most this.
MAX_FACTOR = 128

#: Warps of one block (``kWarps`` in the kernel: 256 threads).
WARPS = 8


#: Entries of each of T's two root tables (``kTwiddleRoots``).
TWIDDLE_ROOTS = 128


def choose_factors(n: int) -> tuple[int, int]:
    """Pick n = n1*n2 with both factors <= 128 and as square as possible,
    as the reference package does (ties go to the larger n1)."""
    best = None
    for n1 in range(min(MAX_FACTOR, n), 0, -1):
        if n % n1 == 0 and n // n1 <= MAX_FACTOR:
            n2 = n // n1
            score = abs(n1 - n2)
            if best is None or score < best[0]:
                best = (score, n1, n2)
    if best is None:
        raise ValueError(f"n={n} has no n1*n2 factorization with both <= "
                         f"{MAX_FACTOR} (max single-kernel n is 16384)")
    return best[1], best[2]


def tile_rows(itemsize: int) -> int:
    """Rows of one tensor-core m-tile: 16 for complex64 (m16n8k8 TF32),
    8 for complex128 (m8n8k4 f64)."""
    return 8 if itemsize == 16 else 16


def m_group(n1: int, n2: int, itemsize: int) -> int:
    """m-tiles a warp sums at once (1, 2 or 4: the kernel's MG): enough
    for every m-tile of either pass, at most 2 for complex64 (whose 3xTF32
    operands take more registers) and 4 for complex128; a longer side
    splits a pass's m-tiles into groups."""
    tiles = -(-max(n1, n2) // tile_rows(itemsize))
    cap = 4 if itemsize == 16 else 2
    return next(g for g in (1, 2, 4) if g >= min(tiles, cap))


def n_tiles(n1: int, n2: int) -> int:
    """8-column tensor-core tiles of a warp's panel (the kernel's NP): two,
    which share each looked-up fragment of W1 or W2, or one when a side
    is at most 8 points (a second tile there would hold only zeros)."""
    return 1 if min(n1, n2) <= 8 else 2


def column_items(n1: int, n2: int, itemsize: int) -> int:
    """Warp items of one signal's column pass: panels of 8 ``n_tiles``
    columns times the groups of m-tiles that cover n1 (a power of two)."""
    tiles = -(-n1 // tile_rows(itemsize))
    groups = 1
    while groups * m_group(n1, n2, itemsize) < tiles:
        groups *= 2
    return -(-n2 // (8 * n_tiles(n1, n2))) * groups


def plane_pitch(n2: int) -> int:
    """Points per padded plane row: n2 rounded up to 4 mod 16, so the
    fragment loads of both passes spread over the banks."""
    return n2 + (4 - n2) % 16


def product_smem_bytes(n1: int, n2: int, tile_b: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of the product body: the root
    tables (W1's and W2's, each for up to 128 points at 16 bytes, and T's
    two of 128 points) and one padded plane per signal."""
    tables = 2 * MAX_FACTOR * 16 + 2 * TWIDDLE_ROOTS * itemsize
    return tables + tile_b * n1 * plane_pitch(n2) * itemsize


def smem_bytes(n1: int, n2: int, tile_b: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of ``tile_b`` signals in the
    split's body (``fft_body``): the FFT body's tables and plane
    (``fft_smem_bytes`` at ``fft_pitch``), or ``product_smem_bytes``."""
    if fft_body(n1, n2):
        rows = tile_b * n1
        return fft_smem_bytes(rows, fft_pitch(n2, rows, itemsize), itemsize)
    return product_smem_bytes(n1, n2, tile_b, itemsize)


# ---- the FFT body ----------------------------------------------------------

#: Radices of the FFT body's register passes (``FFT4_RADICES`` in the
#: kernel); 1 is the one-point side of a prime n.
FFT_RADICES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 15, 16)

#: Register passes of one side at most (``kSidePasses``).
MAX_PASSES = 3

#: Threads of one block of the FFT body (``kFftThreads``), and of one
#: whose plane leaves no room for a second block on its SM
#: (``kFftWideThreads``).
FFT_THREADS = 256
FFT_WIDE_THREADS = 512

#: SMs and shared memory of one SM (228 KB, of which a block may take 227)
#: of an H100 SXM: the card the default tiles are planned for where the
#: device does not say (a CPU tensor); ``ops.card_shape`` reads a CUDA
#: device's own.
CARD_SMS = 132
SM_SMEM_BYTES = 233472

#: Blocks an SM the FFT body's launch bounds plan, by bytes a point
#: (``kFftMinBlocksF`` / ``kFftMinBlocksD``): three in complex64, two in
#: complex128.
FFT_MIN_BLOCKS = {8: 3, 16: 2}

#: The default tile's largest (P7's 64-point signals ran slower at 93
#: than at 64).
MAX_TILE_B = 64

#: Entries of the FFT body's shared tables (``kFftRoots``): W1's and W2's
#: roots and T's two root tables, 128 each.
FFT_ROOTS = 4 * MAX_FACTOR


def fft_body(n1: int, n2: int) -> bool:
    """Does the split n1 x n2 run the FFT body?  Exactly where both sides
    are 7-smooth; any other split runs the product body."""
    return smooth7(n1) and smooth7(n2)


def _pass_flops(m: int, radices: tuple[int, ...]) -> int:
    """Real flops of a side's passes: m/f register FFTs of each radix f,
    and the twiddle multiply (6 flops a point) after every pass but the
    last."""
    return (sum(m // f * reg_fft_flops(f) for f in radices)
            + 6 * m * (len(radices) - 1))


@functools.cache
def side_radices(m: int) -> tuple[int, ...]:
    """The radices of the register passes of a 7-smooth side of m <= 128
    points, first pass first: the fewest passes, then the fewest flops
    (``_pass_flops``), the larger radix first (so the n1 side's last
    radix is the smaller: a warp's 32 rows then store runs of 32/f
    consecutive points)."""
    if m == 1:
        return (1,)
    best = None

    def walk(rest: int, done: tuple[int, ...]) -> None:
        nonlocal best
        if rest == 1:
            r = tuple(sorted(done, reverse=True))
            key = (len(r), _pass_flops(m, r))
            if best is None or key < best[0]:
                best = (key, r)
            return
        if len(done) == MAX_PASSES:
            return
        for f in FFT_RADICES[1:]:
            if rest % f == 0:
                walk(rest // f, done + (f,))

    walk(m, ())
    if best is None:
        raise ValueError(f"side {m} has no split into {MAX_PASSES} register "
                         f"passes of radices {FFT_RADICES[1:]}")
    return best[1]


def fft_pitch(width: int, rows: int, itemsize: int) -> int:
    """Points a row of the FFT body's plane of ``rows`` rows of ``width``:
    the next odd count where the block still fits (a warp reading down a
    column then meets each bank the fewest times), else ``width``."""
    odd = width | 1
    return odd if fft_smem_bytes(rows, odd, itemsize) <= SMEM_LIMIT_BYTES \
        else width


def fft_smem_bytes(rows: int, pitch: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of the FFT body: its tables and
    a plane of ``rows`` rows at ``pitch`` points."""
    return (FFT_ROOTS + rows * pitch) * itemsize


def fft_threads(n1: int, n2: int, tile_b: int, itemsize: int) -> int:
    """Threads of a one-launch block of the FFT body: ``FFT_WIDE_THREADS``
    where its plane takes over half an SM's shared memory (one block an
    SM: 16384 complex64 points, 129 KB), else ``FFT_THREADS``."""
    return FFT_WIDE_THREADS \
        if smem_bytes(n1, n2, tile_b, itemsize) > SMEM_LIMIT_BYTES // 2 \
        else FFT_THREADS


def fft_tile_b(n1: int, n2: int, batch: int, itemsize: int,
               sms: int = CARD_SMS, sm_smem: int = SM_SMEM_BYTES) -> int:
    """The FFT body's default signals per block: enough that each pass has
    four tasks for every thread, few enough that ``FFT_MIN_BLOCKS`` blocks
    share an SM's shared memory (``sm_smem`` bytes) and that the batch
    gives every block slot of the card (``sms`` SMs) four blocks (so that no wave runs part full for long), at
    most ``MAX_TILE_B``, at least one.  (The card's tile sweeps put the
    fastest tile there or next to it: P3's 4096 at 2 (the rule's 2), P5's
    945 at 8 (9), P7's 64 at 64 (64), P1's 128 at 32 (41), P4's 1536 on
    3072 rows at 1 to 2 (1), the 8192 and 16384 planes at 1 (1).)"""
    per_sm = FFT_MIN_BLOCKS[itemsize]
    cap = min(_fft_fill(n1, n2), batch // (4 * sms * per_sm))
    return max(1, min(cap, _fft_fit(n1, n2, itemsize,
                                    sm_smem // per_sm - 1024)))


@functools.cache
def _fft_fill(n1: int, n2: int) -> int:
    """Signals a block of the FFT body needs for four tasks a thread in
    each pass, at most ``MAX_TILE_B``."""
    return min(MAX_TILE_B, -(-4 * FFT_THREADS
                             * max(side_radices(n1) + side_radices(n2))
                             // (n1 * n2)))


@functools.cache
def _fft_fit(n1: int, n2: int, itemsize: int, limit: int) -> int:
    """The largest tile up to ``MAX_TILE_B`` whose block, and every
    smaller tile's, fits ``limit`` bytes of shared memory; at least one.
    (Cached: ``fft`` asks for it on every call.)"""
    tile = 1
    while tile < MAX_TILE_B and smem_bytes(n1, n2, tile + 1, itemsize) \
            <= limit:
        tile += 1
    return tile


def fft_pass_tiles(n1: int, n2: int, itemsize: int) -> tuple[int, int]:
    """The FFT body's two-launch tiles: adjacent columns per block of the
    column launch and adjacent rows per block of the row launch, each the
    largest power of two (from 8) whose plane fits half a block's shared
    memory (two blocks an SM), no more than the side needs."""
    def tile(side: int, smem) -> int:
        t = 8
        while t < side and smem(2 * t) <= SMEM_LIMIT_BYTES // 2:
            t *= 2
        return t

    return (tile(n2, lambda t: fft_smem_bytes(n1, t | 1, itemsize)),
            tile(n1, lambda t: fft_smem_bytes(t, n2 | 1, itemsize)))
