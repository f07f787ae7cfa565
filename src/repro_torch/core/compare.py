"""The comparison core of the perf trajectory (paper §2: reproducible,
unbiased comparison), and the suite-result aggregation.

Every surface that reads or writes ``BENCH_*.json`` trajectory documents
goes through this module: ``benchmarks/bench_grid.py`` (the writer),
``benchmarks/bench_diff.py`` (the regression gate) and
``benchmarks/fit_costmodel.py`` (the cost-model fitter).  It is the
reference package's ``core/compare.py``, stdlib only, so a document
either package writes loads, aligns and reports the same in the other:

* **documents**: :func:`make_meta` stamps a schema-versioned provenance
  header (schema, git sha, device kind, framework version, reps);
  :func:`load_bench` reads and validates a document and normalizes its
  rows, so schema-1 documents (no ``kind``/``precision``/``mode``
  fields) align against schema-2 ones;
* **alignment**: :func:`row_key` / :func:`align_rows` pair rows of two
  runs by ``(mode, backend, extent, kind, precision, rank, devices)``;
* **verdicts**: :func:`diff_docs` applies noise-aware thresholds (the
  pooled standard error of the rows' ``sd_ms``/``n``, and min-effect
  floors so 1-rep smoke runs never flap on jitter), and
  :func:`markdown_report` / :func:`fig7_report` render the delta report
  and the gearshifft Fig. 7 table.

The serve and chaos entries of :data:`METRICS` are kept so a reference
document with such rows loads; the port writes grid rows only.

At the bottom, the mean/stdev core behind ``results.aggregate_rows``,
``ResultSet.aggregate_named`` and the benchmark tables, and the
percentile helper behind ``ResultSet.summary``'s tail-latency view.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
from dataclasses import dataclass, field

#: Version stamped into ``meta["schema"]`` by :func:`make_meta`.  Schema 1
#: (the trajectory documents written before the comparison core existed)
#: has no ``schema`` field at all; the loader back-fills its defaults.
SCHEMA_VERSION = 2

#: Fields a grid row is normalized to carry (schema-1 defaults) — the
#: bench grid has always been the forward c64 float transform.
GRID_ROW_DEFAULTS = {
    "mode": "grid",
    "kind": "Outplace_Complex",
    "precision": "float",
    "devices": 1,
}

#: The cross-run alignment key: backend, extents, kind, precision, rank,
#: device count, plus ``mode`` so serve/chaos rows never collide with grid
#: rows.
ALIGN_KEY = ("mode", "backend", "extent", "kind", "precision", "rank",
             "devices")

#: Per-mode comparison metric: (row field, lower_is_better).
METRICS = {
    "grid": ("time_ms", True),
    "serve_replay": ("p50_ms", True),
    "serve_burst": ("speedup", False),
    "chaos_fallback": ("clean_success_rate", False),
    "chaos_kill": ("clean_success_rate", False),
}


class BenchFormatError(ValueError):
    """A BENCH document failed structural validation."""


# ---------------------------------------------------------------------------
# documents
# ---------------------------------------------------------------------------
def git_sha(cwd: str | None = None) -> str | None:
    """Current commit sha for provenance stamping; None outside a repo."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=cwd,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def make_meta(**fields) -> dict:
    """Schema-versioned provenance header for a BENCH document.

    Callers pass the run facts (``device_kind``, ``platform``, ``torch``,
    ``reps``, ...); this stamps ``schema`` and the current ``git_sha`` so
    every trajectory point records exactly which tree produced it.
    """
    meta = {"schema": SCHEMA_VERSION, "git_sha": git_sha()}
    meta.update(fields)
    return meta


def normalize_row(rec: dict) -> dict:
    """A defensive copy of one result row with schema-1 gaps back-filled
    so alignment keys exist for every document vintage."""
    row = dict(rec)
    row.setdefault("mode", "grid")
    if row["mode"] == "grid":
        for k, v in GRID_ROW_DEFAULTS.items():
            row.setdefault(k, v)
        if "rank" not in row and "extent" in row:
            row["rank"] = len(str(row["extent"]).split("x"))
    else:
        # serve/chaos rows: no extent grid; backend may be absent (chaos)
        row.setdefault("backend", row["mode"])
        row.setdefault("extent", "")
        row.setdefault("kind", "")
        row.setdefault("precision", "")
        row.setdefault("rank", 0)
        row.setdefault("devices", 1)
    row.setdefault("ok", False)
    return row


@dataclass
class BenchDoc:
    """One loaded + normalized BENCH_*.json trajectory document."""

    path: str
    meta: dict
    rows: list[dict]

    @property
    def schema(self) -> int:
        return int(self.meta.get("schema", 1))

    @property
    def git_sha(self) -> str | None:
        return self.meta.get("git_sha")

    @property
    def label(self) -> str:
        return os.path.basename(self.path) or self.path

    def ok_rows(self) -> list[dict]:
        return [r for r in self.rows if r.get("ok")]


_REQUIRED_META = ("device_kind", "platform")


def load_bench(path: str) -> BenchDoc:
    """Load + validate one BENCH document; raises :class:`BenchFormatError`
    with the offending path on malformed input."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except json.JSONDecodeError as e:
        raise BenchFormatError(f"{path}: not valid JSON ({e})") from e
    if not isinstance(doc, dict):
        raise BenchFormatError(f"{path}: top level must be an object")
    meta = doc.get("meta")
    results = doc.get("results")
    if not isinstance(meta, dict):
        raise BenchFormatError(f"{path}: missing 'meta' object")
    if not isinstance(results, list):
        raise BenchFormatError(f"{path}: missing 'results' list")
    missing = [k for k in _REQUIRED_META if k not in meta]
    if missing:
        raise BenchFormatError(f"{path}: meta missing {missing}")
    schema = meta.get("schema", 1)
    if not isinstance(schema, int) or schema < 1:
        raise BenchFormatError(f"{path}: bad meta.schema {schema!r}")
    if schema > SCHEMA_VERSION:
        raise BenchFormatError(
            f"{path}: schema {schema} is newer than supported "
            f"{SCHEMA_VERSION}; upgrade the comparison core")
    rows = []
    for i, rec in enumerate(results):
        if not isinstance(rec, dict):
            raise BenchFormatError(f"{path}: results[{i}] is not an object")
        row = normalize_row(rec)
        if row["mode"] == "grid" and "backend" not in row:
            raise BenchFormatError(f"{path}: results[{i}] has no backend")
        rows.append(row)
    return BenchDoc(path=path, meta=meta, rows=rows)


# ---------------------------------------------------------------------------
# alignment
# ---------------------------------------------------------------------------
def row_key(row: dict) -> tuple:
    """The cross-run identity of one row (see :data:`ALIGN_KEY`)."""
    return tuple(row.get(k) for k in ALIGN_KEY)


def format_key(key: tuple) -> str:
    mode, backend, extent, kind, precision, rank, devices = key
    bits = [backend]
    if extent:
        bits.append(str(extent))
    if mode != "grid":
        bits.insert(0, mode)
    if kind and kind != GRID_ROW_DEFAULTS["kind"]:
        bits.append(kind)
    if precision and precision != GRID_ROW_DEFAULTS["precision"]:
        bits.append(precision)
    if devices and devices != 1:
        bits.append(f"{devices}dev")
    return "/".join(bits)


def align_rows(a_rows: list[dict], b_rows: list[dict]
               ) -> list[tuple[tuple, dict | None, dict | None]]:
    """Pair rows of two runs by :func:`row_key`.

    Order: every key of the baseline run first (in file order), then keys
    only the candidate run has.  Duplicate keys within one run keep the
    first occurrence (and are surfaced by the diff as a doc warning).
    """
    a_by = {}
    for r in a_rows:
        a_by.setdefault(row_key(r), r)
    b_by = {}
    for r in b_rows:
        b_by.setdefault(row_key(r), r)
    out = []
    for r in a_rows:
        k = row_key(r)
        if a_by.get(k) is not r:
            continue                       # duplicate key: first wins
        out.append((k, r, b_by.get(k)))
    for r in b_rows:
        k = row_key(r)
        if k not in a_by and b_by.get(k) is r:
            out.append((k, None, r))
    return out


# ---------------------------------------------------------------------------
# noise-aware verdicts
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Thresholds:
    """When is a delta a *regression* rather than noise?

    A slowdown must clear **every** gate:

    * ``sigma``  — |Δ| > sigma × pooled standard error, where the pooled
      error is ``sqrt(sd_a²/n_a + sd_b²/n_b)`` from the per-row
      ``sd_ms``/``n`` columns (Welch).  Rows without spread data (n ≤ 1 —
      the 1-rep smoke grid — or schema-1 docs) contribute zero, so the
      floors below are the only gate there;
    * ``min_rel`` — |Δ| / baseline ≥ min_rel (the min-effect floor);
    * ``min_abs_ms`` — |Δ| ≥ min_abs_ms, so micro-rows never flap on
      scheduler jitter.
    """

    sigma: float = 3.0
    min_rel: float = 0.10
    min_abs_ms: float = 0.05

    #: Human tag for the report header.
    name: str = "default"


#: Smoke-grade preset: 1 rep, the kernels' plain versions on a CPU,
#: possibly a different host than the committed baseline — only
#: order-of-magnitude slowdowns (or feasibility regressions, which ignore
#: thresholds entirely) gate.
SMOKE_THRESHOLDS = Thresholds(sigma=3.0, min_rel=4.0, min_abs_ms=1.0,
                              name="smoke")

VERDICTS = ("regression", "improvement", "unchanged", "added", "removed")


@dataclass
class DiffRow:
    key: tuple
    verdict: str                  # one of VERDICTS
    detail: str = ""
    metric: str = ""
    a_value: float | None = None
    b_value: float | None = None
    delta_rel: float | None = None   # (b - a) / a, sign of the raw delta
    stderr: float | None = None      # pooled standard error (metric units)

    @property
    def name(self) -> str:
        return format_key(self.key)


@dataclass
class DiffResult:
    baseline: BenchDoc
    candidate: BenchDoc
    thresholds: Thresholds
    rows: list[DiffRow] = field(default_factory=list)
    warnings: list[str] = field(default_factory=list)

    def count(self, verdict: str) -> int:
        return sum(1 for r in self.rows if r.verdict == verdict)

    @property
    def regressions(self) -> list[DiffRow]:
        return [r for r in self.rows if r.verdict == "regression"]

    @property
    def has_regression(self) -> bool:
        return bool(self.regressions)


def _spread(row: dict) -> tuple[float, int]:
    """(sd, n) of the row's comparison metric; (0, 1) when unknown."""
    n = int(row.get("n", row.get("reps", 1)) or 1)
    sd = float(row.get("sd_ms", 0.0) or 0.0)
    return sd, max(n, 1)


def pooled_stderr(row_a: dict, row_b: dict) -> float:
    """Welch pooled standard error of the difference of two row means."""
    sd_a, n_a = _spread(row_a)
    sd_b, n_b = _spread(row_b)
    return math.sqrt(sd_a ** 2 / n_a + sd_b ** 2 / n_b)


def compare_pair(key: tuple, row_a: dict | None, row_b: dict | None,
                 th: Thresholds) -> DiffRow:
    """Noise-aware verdict for one aligned pair (either side may be None)."""
    if row_a is None:
        return DiffRow(key, "added", detail="no baseline row")
    if row_b is None:
        return DiffRow(key, "removed", detail="row missing from candidate")
    ok_a, ok_b = bool(row_a.get("ok")), bool(row_b.get("ok"))
    if ok_a and not ok_b:
        return DiffRow(key, "regression",
                       detail="feasibility lost: "
                              f"{row_b.get('error', 'not ok')}")
    if not ok_a and ok_b:
        return DiffRow(key, "improvement", detail="now feasible")
    if not ok_a and not ok_b:
        return DiffRow(key, "unchanged", detail="infeasible in both runs")
    metric, lower_better = METRICS.get(key[0], ("time_ms", True))
    va, vb = row_a.get(metric), row_b.get(metric)
    if va is None or vb is None:
        return DiffRow(key, "unchanged", metric=metric,
                       detail=f"metric {metric} missing")
    va, vb = float(va), float(vb)
    delta = vb - va
    worse = delta if lower_better else -delta
    stderr = pooled_stderr(row_a, row_b)
    rel = (delta / va if va
           else 0.0 if delta == 0 else math.copysign(math.inf, delta))
    row = DiffRow(key, "unchanged", metric=metric, a_value=va, b_value=vb,
                  delta_rel=rel, stderr=stderr)
    gate = max(th.min_abs_ms, th.sigma * stderr, th.min_rel * abs(va))
    if worse > gate:
        row.verdict = "regression"
        row.detail = (f"{metric} {'+' if delta >= 0 else ''}{rel:.0%} "
                      f"exceeds gate")
    elif -worse > gate:
        row.verdict = "improvement"
    else:
        row.detail = "within noise"
    return row


def diff_docs(baseline: BenchDoc, candidate: BenchDoc,
              thresholds: Thresholds = Thresholds()) -> DiffResult:
    """Align two trajectory documents and classify every paired row."""
    res = DiffResult(baseline, candidate, thresholds)
    for doc in (baseline, candidate):
        seen, dups = set(), set()
        for r in doc.rows:
            k = row_key(r)
            (dups if k in seen else seen).add(k)
        for k in sorted(dups):
            res.warnings.append(
                f"{doc.label}: duplicate row key {format_key(k)} "
                "(first occurrence used)")
    if baseline.meta.get("device_kind") != candidate.meta.get("device_kind"):
        res.warnings.append(
            "device kinds differ "
            f"({baseline.meta.get('device_kind')!r} vs "
            f"{candidate.meta.get('device_kind')!r}): absolute times are "
            "not comparable; rely on feasibility + large relative deltas")
    for key, ra, rb in align_rows(baseline.rows, candidate.rows):
        res.rows.append(compare_pair(key, ra, rb, thresholds))
    return res


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------
def _meta_line(doc: BenchDoc) -> str:
    sha = (doc.git_sha or "?")[:12]
    m = doc.meta
    reps = m.get("reps", "?")
    # the framework that wrote the document: the port's say torch, the
    # reference's jax
    fw = "torch" if "torch" in m else "jax"
    return (f"`{doc.label}` — schema {doc.schema}, git `{sha}`, "
            f"device {m.get('device_kind', '?')} "
            f"({m.get('platform', '?')}), {fw} {m.get(fw, '?')}, "
            f"reps {reps}")


def _fmt(v: float | None) -> str:
    return "-" if v is None else f"{v:.3f}"


def markdown_report(res: DiffResult) -> str:
    """The bench_diff delta report: provenance, per-row verdicts, summary."""
    th = res.thresholds
    lines = [
        "# bench_diff report",
        "",
        f"- baseline:  {_meta_line(res.baseline)}",
        f"- candidate: {_meta_line(res.candidate)}",
        f"- thresholds: `{th.name}` (sigma={th.sigma:g}, "
        f"min_rel={th.min_rel:.0%}, min_abs={th.min_abs_ms:g} ms)",
        "",
    ]
    for w in res.warnings:
        lines.append(f"> **warning:** {w}")
    if res.warnings:
        lines.append("")
    lines += [
        "| row | metric | baseline | candidate | Δ | noise (±σ) | verdict |",
        "|---|---|---|---|---|---|---|",
    ]
    order = {v: i for i, v in enumerate(VERDICTS)}
    for r in sorted(res.rows, key=lambda r: (order[r.verdict], r.name)):
        delta = ("-" if r.delta_rel is None
                 else f"{'+' if r.delta_rel >= 0 else ''}{r.delta_rel:.1%}")
        noise = "-" if not r.stderr else f"{r.stderr:.3f}"
        verdict = (f"**{r.verdict}**" if r.verdict == "regression"
                   else r.verdict)
        note = f" ({r.detail})" if r.detail and r.verdict != "unchanged" else ""
        lines.append(f"| {r.name} | {r.metric or '-'} | {_fmt(r.a_value)} | "
                     f"{_fmt(r.b_value)} | {delta} | {noise} | "
                     f"{verdict}{note} |")
    n_reg = res.count("regression")
    lines += [
        "",
        f"**{n_reg} regression(s)**, {res.count('improvement')} "
        f"improvement(s), {res.count('unchanged')} unchanged, "
        f"{res.count('added')} added, {res.count('removed')} removed "
        f"over {len(res.rows)} aligned rows.",
        "",
        ("VERDICT: FAIL — candidate regresses the baseline." if n_reg
         else "VERDICT: PASS — no regression against the baseline."),
    ]
    return "\n".join(lines) + "\n"


#: Paper extent-class display order for the Fig. 7 table.
_CLASS_ORDER = {"powerof2": 0, "radix357": 1, "oddshape": 2}


def fig7_report(doc: BenchDoc) -> str:
    """The repo's living gearshifft Fig. 7: support matrix × extent class ×
    achieved fraction of the roofline.

    One row per (backend, devices), one column per (extent class, rank);
    each cell is the best ``roofline_frac`` the backend achieved over that
    class (achieved fraction of the hardware's modeled peak), ``·`` where
    every grid point was infeasible, blank where none was attempted.
    """
    grid = [r for r in doc.rows if r["mode"] == "grid"]
    cols = sorted({(r.get("class", "?"), r["rank"]) for r in grid},
                  key=lambda c: (_CLASS_ORDER.get(c[0], 9), c[1]))
    backends = sorted({(r["backend"], r["devices"]) for r in grid})
    cells: dict[tuple, dict[tuple, list]] = {}
    for r in grid:
        col = (r.get("class", "?"), r["rank"])
        cells.setdefault((r["backend"], r["devices"]), {}) \
             .setdefault(col, []).append(r)
    m = doc.meta
    lines = [
        "# Fig. 7 — achieved fraction of roofline by backend × extent class",
        "",
        f"- source: {_meta_line(doc)}",
        "- cell = best achieved fraction of the modeled roofline "
        "(`roofline_frac`: ideal time at the device's peak FLOP/s and "
        "HBM bandwidth over measured time); `·` = infeasible, blank = "
        "not attempted.",
        "",
        "| backend | " + " | ".join(f"{c}/{r}d" for c, r in cols) + " |",
        "|" + "---|" * (len(cols) + 1),
    ]
    for backend, devices in backends:
        name = backend if devices == 1 else f"{backend} @{devices}dev"
        row = [name]
        for col in cols:
            rs = cells.get((backend, devices), {}).get(col)
            if not rs:
                row.append("")
                continue
            fracs = [r["roofline_frac"] for r in rs
                     if r.get("ok") and isinstance(
                         r.get("roofline_frac"), (int, float))
                     and math.isfinite(r["roofline_frac"])]
            if fracs:
                row.append(f"{max(fracs):.1%}")
            elif any(r.get("ok") for r in rs):
                row.append("?")        # ran, but no roofline data (schema 1)
            else:
                row.append("·")
        lines.append("| " + " | ".join(row) + " |")
    n_ok = sum(1 for r in grid if r.get("ok"))
    lines += ["", f"{n_ok}/{len(grid)} grid points feasible."]
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# suite-result aggregation
# ---------------------------------------------------------------------------
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
