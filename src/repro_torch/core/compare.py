"""Suite-result aggregation: the one mean/stdev core behind
``results.aggregate_rows``, ``ResultSet.aggregate_named`` and the
benchmark tables, and the percentile helper behind
``ResultSet.summary``'s tail-latency view.

The reference package's ``core/compare.py`` also aggregates percentiles
per group (read by its serving table) and reads, aligns and diffs
``BENCH_*.json`` trajectory documents; the port has neither reader yet,
so this module is its mean/stdev and percentile sections alone, stdlib
only.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass

#: Tail-latency quantiles shared with ``results.percentile_summary``.
PERCENTILES = (50, 95, 99)


def percentile(vals, q: float) -> float:
    """q-th percentile (0..100), linear interpolation between closest
    ranks: ``numpy.percentile``'s default method."""
    if not vals:
        raise ValueError("percentile of empty sequence")
    s = sorted(vals)
    if len(s) == 1:
        return float(s[0])
    pos = (len(s) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))


@dataclass(frozen=True)
class AggStats:
    """mean/sd/n of one measurement group."""

    mean: float
    sd: float
    n: int

    @classmethod
    def of(cls, vals) -> "AggStats":
        return cls(mean=statistics.fmean(vals),
                   sd=statistics.stdev(vals) if len(vals) > 1 else 0.0,
                   n=len(vals))


@dataclass(frozen=True)
class AggRow:
    """One aggregated suite-result group with named fields (``a.library``,
    ``a.mean``, ...)."""

    library: str
    extents: str
    precision: str
    kind: str
    rigor: str
    op: str
    stats: AggStats

    @property
    def mean(self) -> float:
        return self.stats.mean

    @property
    def sd(self) -> float:
        return self.stats.sd

    @property
    def n(self) -> int:
        return self.stats.n

    def as_tuple(self) -> tuple:
        """The positional layout of ``results.aggregate_rows``."""
        return (self.library, self.extents, self.precision, self.kind,
                self.rigor, self.op, self.mean, self.sd, self.n)


def aggregate_result_rows(rows, op: str | None = None) -> list[AggRow]:
    """Group successful suite-result rows by (library, extents, precision,
    kind, rigor, op) into :class:`AggStats`, sorted by key."""
    groups: dict[tuple, list[float]] = {}
    for r in rows:
        if not r.success or (op is not None and r.op != op):
            continue
        key = (r.library, r.extents, r.precision, r.kind, r.rigor, r.op)
        groups.setdefault(key, []).append(r.time_ms)
    return [AggRow(*key, AggStats.of(vals))
            for key, vals in sorted(groups.items())]
