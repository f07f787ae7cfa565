"""The fused four-step FFT kernel and its launch.

The kernel is CUDA C++ (``repro_torch/csrc/fft4step.cu``).  It replaces
the reference package's Pallas kernel ``fft4step`` (``_fft4step_kernel``):
for a tile of signals of length n = n1*n2 it computes the column DFTs
W1 @ X, the twiddle multiply by T and the row DFTs @ W2 on chip, and
writes the (n2, n1) transpose, which read flat is the natural-order
spectrum.  The two products run on the tensor cores through ``mma.sync``
(``csrc/tc_product.cuh``): 3xTF32 for complex64 (each fp32 operand split
into a TF32 high part and remainder, three products summed in fp32, which
keeps the suite's accuracy bar that plain TF32 breaks), fp64 for
complex128.  Each signal lives in one shared-memory plane, computed in
place; W1, W2 and T come from small root tables.  A complex128 signal
whose plane one block does not hold (13824, 16384) runs as two launches:
the column products times T into a scratch signal, then the row
products, each block holding a tile of columns or rows.

This module keeps the launch's host side: the factor choice (the
reference's, exactly), the warp groups, the two-launch tiles, and the
shared-memory size of one block.
"""

from __future__ import annotations

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


def smem_bytes(n1: int, n2: int, tile_b: int, itemsize: int) -> int:
    """Dynamic shared memory of one block: the root tables (W1's and W2's,
    each for up to 128 points at 16 bytes, and T's two of 128 points) and
    one padded plane per signal."""
    tables = 2 * MAX_FACTOR * 16 + 2 * TWIDDLE_ROOTS * itemsize
    return tables + tile_b * n1 * plane_pitch(n2) * itemsize
