"""Extents handling: parsing, formatting and the paper's extent classes
(powerof2 / radix357 / oddshape, Fig. 7), with the '-e 128x128 1024'
syntax."""

from __future__ import annotations

from typing import Sequence


def parse_extents(spec: str) -> tuple[int, ...]:
    """'128x128x128' -> (128, 128, 128); '1024' -> (1024,)."""
    try:
        ext = tuple(int(p) for p in spec.lower().split("x"))
    except ValueError as e:
        raise ValueError(f"bad extents spec {spec!r}") from e
    if not ext or any(v < 1 for v in ext) or len(ext) > 3:
        raise ValueError(f"bad extents spec {spec!r} (rank 1..3, positive)")
    return ext


def format_extents(ext: Sequence[int]) -> str:
    return "x".join(str(v) for v in ext)


def _factors_only(n: int, primes: Sequence[int]) -> bool:
    for p in primes:
        while n % p == 0:
            n //= p
    return n == 1


def next_pow2(v: int) -> int:
    """Smallest power of two >= v."""
    m = 1
    while m < v:
        m *= 2
    return m


def next_smooth(v: int, primes: Sequence[int] = (2, 3, 5, 7)) -> int:
    """Smallest integer >= v whose prime factors all lie in ``primes``."""
    v = max(1, v)
    while not _factors_only(v, primes):
        v += 1
    return v


def classify(ext: Sequence[int]) -> str:
    """Paper extent classes: powerof2 | radix357 | oddshape."""
    if all(v & (v - 1) == 0 for v in ext):
        return "powerof2"
    if all(_factors_only(v, (2, 3, 5, 7)) for v in ext):
        return "radix357"
    return "oddshape"
