"""Extents handling: parsing, formatting, the paper's extent classes
(powerof2 / radix357 / oddshape, Fig. 7) and their sweep generators, with
the '-e 128x128 1024' syntax."""

from __future__ import annotations

import math
from typing import Iterator, Sequence


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


def total_elems(ext: Sequence[int]) -> int:
    return math.prod(ext)


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


def powerof2_extents(rank: int, min_exp: int, max_exp: int) -> Iterator[tuple[int, ...]]:
    for e in range(min_exp, max_exp + 1):
        yield (2 ** e,) * rank


def radix357_extents(rank: int, count: int = 8, start: int = 3) -> Iterator[tuple[int, ...]]:
    """Sizes of the form 2^a * 3^b * 5^c * 7^d that are not powers of two,
    scanning upward from ``start`` one at a time (powers of 3 alone make
    the sequence infinite, so this always terminates)."""
    emitted, v = 0, start
    while emitted < count:
        if _factors_only(v, (2, 3, 5, 7)) and (v & (v - 1)):
            yield (v,) * rank
            emitted += 1
        v += 1


def oddshape_extents(rank: int, count: int = 6) -> Iterator[tuple[int, ...]]:
    """Powers of 19 and friends (the paper's power-of-19 oddshape runs)."""
    base = [19, 19 * 19, 19 ** 3, 11 ** 3, 13 ** 3, 17 ** 3, 23 ** 3, 19 ** 4]
    for v in base[:count]:
        yield (v,) * rank


#: Generator-backed sweep classes a SuiteSpec can name instead of listing
#: extents explicitly: the paper's three extent classes (Fig. 7).
SWEEP_CLASSES = ("powerof2", "radix357", "oddshape")

_SWEEP_PARAMS = {
    "powerof2": {"min_exp", "max_exp"},
    "radix357": {"count", "start"},
    "oddshape": {"count"},
}


def sweep_extents(extent_class: str, rank: int, **params) -> list[tuple[int, ...]]:
    """Expand a named sweep class into concrete extents.

    ``powerof2`` requires ``min_exp``/``max_exp``; ``radix357`` accepts
    ``count``/``start``; ``oddshape`` accepts ``count``.  Unknown classes and
    unknown/missing parameters raise ``ValueError`` (the reference's
    messages) so a bad spec file fails before any benchmark runs.
    """
    if extent_class not in SWEEP_CLASSES:
        raise ValueError(f"unknown sweep class {extent_class!r}; "
                         f"known: {', '.join(SWEEP_CLASSES)}")
    if rank < 1 or rank > 3:
        raise ValueError(f"sweep rank must be 1..3, got {rank}")
    extra = set(params) - _SWEEP_PARAMS[extent_class]
    if extra:
        raise ValueError(f"sweep class {extent_class!r} does not accept "
                         f"{sorted(extra)}; allowed: "
                         f"{sorted(_SWEEP_PARAMS[extent_class])}")
    if extent_class == "powerof2":
        missing = {"min_exp", "max_exp"} - set(params)
        if missing:
            raise ValueError(f"powerof2 sweep requires {sorted(missing)}")
        return list(powerof2_extents(rank, params["min_exp"], params["max_exp"]))
    if extent_class == "radix357":
        return list(radix357_extents(rank, **params))
    return list(oddshape_extents(rank, **params))
