"""The fused four-step FFT kernel and its launch.

The kernel is CUDA C++ (``repro_torch/csrc/fft4step.cu``).  It replaces
the reference package's Pallas kernel ``fft4step`` (``_fft4step_kernel``):
for a tile of signals of length n = n1*n2 it computes the column DFTs
W1 @ X, the twiddle multiply by T and the row DFTs @ W2 on chip, and
writes the (n2, n1) transpose, which read flat is the natural-order
spectrum.  The two products run on the CUDA cores (fp32 FMA for
complex64, fp64 for complex128), not on the tensor cores: TF32 would
break the suite's accuracy bar.

This module keeps the launch's host side: the factor choice (the
reference's, exactly), the register tile, and the shared-memory size of
one block.
"""

from __future__ import annotations

#: Largest factor of the split: both n1 and n2 are at most this.
MAX_FACTOR = 128

#: Threads of one block (``kThreads`` in the kernel).
THREADS = 256


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


def register_tile(n: int) -> int:
    """Outputs per thread along each axis of a pass's product: 4x4 register
    tiles from n = 256 on, 2x2 below, where 4x4 tiles would give a signal
    too few threads."""
    return 4 if n >= 256 else 2


def threads_per_signal(n1: int, n2: int) -> int:
    """Threads that one signal's passes keep busy."""
    rt = register_tile(n1 * n2)
    return -(-n1 // rt) * -(-n2 // rt)


def smem_bytes(n1: int, n2: int, tile_b: int, itemsize: int) -> int:
    """Dynamic shared memory of one block: the tile's signals (X) and their
    column DFTs (C), whose rows are padded to n2 + 1 points."""
    return tile_b * (n1 * n2 + n1 * (n2 + 1)) * itemsize
