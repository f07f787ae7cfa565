"""Stage schedule of the fused mixed-radix Stockham FFT.

The kernel itself is CUDA C++ (``repro_torch/csrc/stockham.cu``); this
module keeps the host-side schedule it runs, identical to the reference
package's: the odd prime factors of a 7-smooth ``n`` as radix-7/5/3 work
stages, then ``radix`` power-of-two stages with a single 4/2 cleanup.
"""

from __future__ import annotations

#: Tunable radix schedules (largest pow2 work stage; odd factors always run
#: as their own radix-3/5/7 stages).
RADICES = (2, 4, 8)

#: The prime factors the stage chain can express (the radix357 class).
SMOOTH_PRIMES = (2, 3, 5, 7)


def smooth7(n: int) -> bool:
    """Is ``n`` of the form 2^a * 3^b * 5^c * 7^d (n >= 1)?"""
    if n < 1:
        return False
    for p in SMOOTH_PRIMES:
        while n % p == 0:
            n //= p
    return n == 1


def radix_schedule(n: int, radix: int = 8) -> tuple[int, ...]:
    """Static mixed-radix stage schedule for a 7-smooth ``n`` (e.g.
    n=3*2^10, radix=8 -> (3, 8, 8, 8, 2)).  The stage product is ``n``."""
    if not smooth7(n):
        raise ValueError("stockham_pallas requires a 7-smooth "
                         f"(2^a*3^b*5^c*7^d) length, got {n}")
    if radix not in RADICES:
        raise ValueError(f"radix must be one of {RADICES}, got {radix}")
    out = []
    m = n
    for p in (7, 5, 3):
        while m % p == 0:
            out.append(p)
            m //= p
    k = m.bit_length() - 1
    step = radix.bit_length() - 1
    while k >= step:
        out.append(radix)
        k -= step
    if k == 2:
        out.append(4)
    elif k == 1:
        out.append(2)
    return tuple(out)
