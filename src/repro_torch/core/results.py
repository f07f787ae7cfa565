"""Standardized result output: one row per (benchmark configuration, run,
operation), identification columns first, then the measurement.  The
schema is the reference package's, column for column, so port rows and
reference rows line up in one analysis.

The ``plan_cache`` column exists only when the plan cache is enabled.
"""

from __future__ import annotations

import csv
import io
import json
import os
from dataclasses import dataclass

from .compare import PERCENTILES, aggregate_result_rows, percentile

COLUMNS = [
    "library", "device", "extents", "rank", "extent_class", "precision",
    "kind", "rigor", "run", "op", "time_ms", "bytes", "success", "error",
]

#: Extra column emitted when the plan cache is enabled.
PLAN_CACHE_COLUMN = "plan_cache"

#: Extra column emitted when plans carry a provenance (wisdom, later).
PLAN_SOURCE_COLUMN = "plan_source"


def columns_for(plan_cache: bool, plan_source: bool = False) -> list[str]:
    """Result schema: seed columns, plus cache accounting when the plan
    cache is on, plus plan provenance when asked for."""
    cols = list(COLUMNS)
    if plan_cache:
        cols.append(PLAN_CACHE_COLUMN)
    if plan_source:
        cols.append(PLAN_SOURCE_COLUMN)
    return cols


@dataclass
class Row:
    library: str
    device: str
    extents: str
    rank: int
    extent_class: str
    precision: str
    kind: str
    rigor: str
    run: int
    op: str
    time_ms: float
    bytes: int = 0
    success: bool = True
    error: str = ""
    plan_cache: str = ""   # ''|'hit'|'miss' (column present only when caching)
    plan_source: str = ""

    def as_list(self, columns: list[str] = COLUMNS):
        return [getattr(self, c) for c in columns]

    def as_dict(self, columns: list[str] = COLUMNS):
        return {c: getattr(self, c) for c in columns}


class ResultSink:
    """Row consumer interface: ``add`` rows, ``save`` to finalize."""

    def __init__(self, path: str, columns: list[str] | None = None):
        self.path = path
        self.columns = list(columns) if columns is not None else list(COLUMNS)
        self.n_rows = 0
        self.n_failures = 0

    def add(self, row: Row) -> None:
        self.n_rows += 1
        if not row.success:
            self.n_failures += 1
        self._write(row)

    def _write(self, row: Row) -> None:
        raise NotImplementedError

    def save(self) -> str:
        """Finalize (close handles); returns the path."""
        return self.path

    def _open(self):
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        return open(self.path, "w", newline="")


class CsvSink(ResultSink):
    """Streaming CSV: header on first row, every row flushed immediately."""

    def __init__(self, path: str, columns: list[str] | None = None):
        super().__init__(path, columns)
        self._fh = None
        self._csv = None

    def _write(self, row: Row) -> None:
        if self._fh is None:
            self._fh = self._open()
            self._csv = csv.writer(self._fh)
            self._csv.writerow(self.columns)
        self._csv.writerow(row.as_list(self.columns))
        self._fh.flush()

    def save(self) -> str:
        if self._fh is None:       # no rows: still leave a valid header-only file
            self._fh = self._open()
            csv.writer(self._fh).writerow(self.columns)
        self._fh.close()
        self._fh = self._csv = None
        return self.path


class JsonlSink(ResultSink):
    """Streaming JSON-lines: one object per row, same column order as CSV."""

    def __init__(self, path: str, columns: list[str] | None = None):
        super().__init__(path, columns)
        self._fh = None

    def _write(self, row: Row) -> None:
        if self._fh is None:
            self._fh = self._open()
        self._fh.write(json.dumps(row.as_dict(self.columns)) + "\n")
        self._fh.flush()

    def save(self) -> str:
        if self._fh is None:
            self._fh = self._open()
        self._fh.close()
        self._fh = None
        return self.path


def open_sink(path: str, fmt: str | None = None,
              columns: list[str] | None = None) -> ResultSink:
    """Sink factory: explicit ``fmt`` ('csv'|'jsonl') or by file extension."""
    if fmt is None:
        fmt = "jsonl" if path.endswith((".jsonl", ".ndjson")) else "csv"
    if fmt == "jsonl":
        return JsonlSink(path, columns)
    if fmt == "csv":
        return CsvSink(path, columns)
    raise ValueError(f"unknown sink format {fmt!r}")


class ResultWriter(ResultSink):
    """Buffer-everything sink: keeps rows in memory for aggregation
    (paper-style figures) and writes the whole CSV on :meth:`save`."""

    def __init__(self, path: str = "result.csv",
                 columns: list[str] | None = None):
        super().__init__(path, columns)
        self.rows: list[Row] = []

    def _write(self, row: Row) -> None:
        self.rows.append(row)

    def save(self) -> str:
        return save_csv(self.path, self.rows, self.columns)

    def to_csv_string(self) -> str:
        return rows_to_csv(self.rows, self.columns)

    def aggregate(self, op: str | None = None):
        """mean/stdev per (library, extents, precision, kind, rigor, op)."""
        return aggregate_rows(self.rows, op)


def rows_to_csv(rows, columns) -> str:
    """Header + every row as one CSV string."""
    buf = io.StringIO()
    w = csv.writer(buf)
    w.writerow(columns)
    for r in rows:
        w.writerow(r.as_list(columns))
    return buf.getvalue()


def save_csv(path: str, rows, columns) -> str:
    """Write ``rows_to_csv`` to ``path``, creating parent dirs."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", newline="") as f:
        f.write(rows_to_csv(rows, columns))
    return path


def percentile_summary(vals, quantiles=PERCENTILES) -> dict:
    """``{"p50": ..., "p95": ..., "p99": ...}`` over ``vals`` (ms)."""
    return {f"p{q:g}": percentile(vals, q) for q in quantiles}


def aggregate_rows(rows, op: str | None = None, percentiles: bool = False):
    """``(library, extents, precision, kind, rigor, op, mean, sd, n)`` per
    group of successful rows, sorted by key: the reference package's
    aggregation layout.  ``percentiles=True`` puts p50/p95/p99 between sd
    and n (``(*key, mean, sd, p50, p95, p99, n)``): the tail-latency view
    the serving reports read."""
    return [a.as_tuple()
            for a in aggregate_result_rows(rows, op, percentiles=percentiles)]
