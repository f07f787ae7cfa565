"""Declarative suite descriptions + the Session facade.

gearshifft drives every library binary from one configuration surface
(extents files + CLI flags) so cross-library comparisons stay
reproducible.  This module is that surface for the port:

* :class:`SuiteSpec`: a frozen, serializable description of one benchmark
  run: which clients (and extra client modules to load), which extents
  (explicit lists *and* generator-backed sweep classes
  ``powerof2``/``radix357``/``oddshape``), kinds, precisions, batch, a
  ``-r`` selection, planner rigor, warmups/repetitions, error bound, seed,
  plan-cache policy, wisdom path, cost-model table and the result sink.
  Round-trips to TOML (the ``-f extents_file`` analogue) and JSON in the
  reference package's text, so a spec file written by either package is
  read by the other once the client titles are mapped.
* :class:`Session`: owns the device context, the wisdom store, the
  (shareable) plan cache and the result sinks.  ``Session.run(spec)``
  returns a :class:`ResultSet`; :func:`run_suite` runs one spec in a
  fresh (or given) Session.
* :class:`ResultSet`: the materialized rows of a run plus the
  aggregation/query helpers the tables consume.

The CLI (:mod:`repro_torch.core.cli`) is a thin argparse -> SuiteSpec
adapter, every ``benchmarks/table_*.py`` is a spec run through
``run_suite``, and Python callers construct specs directly: one run
description behind all three surfaces.
"""

from __future__ import annotations

import importlib
import json
import os
import statistics
from contextlib import nullcontext
from dataclasses import dataclass, fields
from typing import Any, Iterable, Iterator, Optional, Sequence

import torch.distributed as dist

from .benchmark import BenchmarkConfig, run_nodes
from .compare import AggRow, aggregate_result_rows
from .client import KINDS, PRECISIONS, TorchContext
from .extents import SWEEP_CLASSES, format_extents, parse_extents, sweep_extents
from .plan import PlanCache, PlanCacheStats, PlanRigor
from .registry import get_client
from .results import (ResultSink, Row, aggregate_rows, columns_for,
                      open_sink, percentile_summary, rows_to_csv, save_csv)
from .tree import BenchNode, build_tree, select
from .wisdom import Wisdom


# ---------------------------------------------------------------------------
# sweep specs: generator-backed extent classes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SweepSpec:
    """One generator-backed extent sweep (paper Fig. 7 extent classes).

    ``extent_class`` is one of ``powerof2`` (requires ``min_exp``/``max_exp``),
    ``radix357`` (optional ``count``/``start``) or ``oddshape`` (optional
    ``count``); ``rank`` repeats the size along 1..3 dimensions.
    """

    extent_class: str
    rank: int = 1
    min_exp: Optional[int] = None
    max_exp: Optional[int] = None
    count: Optional[int] = None
    start: Optional[int] = None

    def __post_init__(self):
        # validate eagerly: a bad sweep must fail at spec-build time
        self.extents()

    def extents(self) -> list[tuple[int, ...]]:
        params = {k: getattr(self, k)
                  for k in ("min_exp", "max_exp", "count", "start")
                  if getattr(self, k) is not None}
        return sweep_extents(self.extent_class, self.rank, **params)

    def to_dict(self) -> dict:
        d = {"class": self.extent_class, "rank": self.rank}
        for k in ("min_exp", "max_exp", "count", "start"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SweepSpec":
        d = dict(d)
        extent_class = d.pop("class", None) or d.pop("extent_class", None)
        if extent_class is None:
            raise ValueError(f"sweep entry missing 'class': {d}")
        known = {"rank", "min_exp", "max_exp", "count", "start"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown sweep key(s) {sorted(unknown)}; "
                             f"allowed: class, {', '.join(sorted(known))}")
        return cls(extent_class=extent_class, **d)


def _as_extent(v) -> tuple[int, ...]:
    if isinstance(v, str):
        return parse_extents(v)
    if isinstance(v, int):
        return (v,)
    return parse_extents(format_extents(tuple(int(x) for x in v)))


# ---------------------------------------------------------------------------
# the suite spec
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SuiteSpec:
    """A complete, serializable description of one benchmark run.

    :meth:`to_toml` / :meth:`from_toml` (and the JSON twins) round-trip to
    an equal spec, so ``--dump-config`` -> ``--config`` replays any CLI
    invocation exactly.  The fields and their order are the reference's.
    ``device_counts`` is the multi-device scaling axis that the grid's
    ``--devices`` mode (``benchmarks/bench_grid.py``) fans out over, one
    group of ranks per count.
    """

    clients: tuple[str, ...] = ("TorchFFT",)
    load: tuple[str, ...] = ()                  # extra client modules
    extents: tuple[tuple[int, ...], ...] = ()   # explicit extents
    sweeps: tuple[SweepSpec, ...] = ()          # generator-backed extents
    kinds: tuple[str, ...] = KINDS
    precisions: tuple[str, ...] = ("float",)
    batch: int = 1
    device_counts: tuple[int, ...] = ()         # multi-device scaling axis
    select: Optional[str] = None                # '-r' wildcard pattern
    rigor: str = "estimate"
    warmups: int = 1
    repetitions: int = 3
    error_bound: float = 1e-5
    seed: int = 2017
    plan_cache: bool = True
    wisdom: Optional[str] = None                # wisdom JSON path
    costmodel: Optional[str] = None             # coefficient table path
    output: Optional[str] = "result.csv"        # None = in-memory only
    format: Optional[str] = None                # 'csv' | 'jsonl' | by extension
    verbose: bool = False

    def __post_init__(self):
        norm = object.__setattr__
        norm(self, "clients", tuple(str(c) for c in self.clients))
        norm(self, "load", tuple(str(m) for m in self.load))
        norm(self, "extents", tuple(_as_extent(e) for e in self.extents))
        norm(self, "sweeps", tuple(
            s if isinstance(s, SweepSpec) else SweepSpec.from_dict(s)
            for s in self.sweeps))
        norm(self, "kinds", tuple(self.kinds))
        norm(self, "precisions", tuple(self.precisions))
        norm(self, "device_counts", tuple(int(n) for n in self.device_counts))
        if any(n < 1 for n in self.device_counts):
            raise ValueError(f"device_counts must be >= 1, "
                             f"got {self.device_counts}")
        if isinstance(self.rigor, PlanRigor):
            norm(self, "rigor", self.rigor.value)
        bad = set(self.kinds) - set(KINDS)
        if bad:
            raise ValueError(f"unknown kind(s) {sorted(bad)}; known: {KINDS}")
        bad = set(self.precisions) - set(PRECISIONS)
        if bad:
            raise ValueError(
                f"unknown precision(s) {sorted(bad)}; known: {PRECISIONS}")
        if self.rigor not in {r.value for r in PlanRigor}:
            raise ValueError(f"unknown rigor {self.rigor!r}; known: "
                             f"{[r.value for r in PlanRigor]}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.warmups < 0 or self.repetitions < 0:
            raise ValueError("warmups/repetitions must be >= 0")
        if self.format is not None and self.format not in ("csv", "jsonl"):
            raise ValueError(f"unknown format {self.format!r}")

    # --- node tree ---------------------------------------------------------
    def resolved_extents(self) -> tuple[tuple[int, ...], ...]:
        """Explicit extents followed by every sweep's expansion, in order."""
        out = list(self.extents)
        for sweep in self.sweeps:
            out.extend(sweep.extents())
        return tuple(out)

    def load_modules(self) -> None:
        """Import the spec's extra client modules (registry side effects)."""
        for mod in self.load:
            importlib.import_module(mod)

    def build_nodes(self) -> list[BenchNode]:
        """Materialize the benchmark tree this spec describes, filtered by
        its ``select`` pattern."""
        from .clients import (dist_fft, serve_fft,  # noqa: F401  (registers)
                              torch_fft)
        self.load_modules()
        exts = self.resolved_extents()
        if not exts:
            raise ValueError(
                "spec resolves no extents: give 'extents' and/or 'sweeps'")
        nodes = build_tree([get_client(c) for c in self.clients], exts,
                           kinds=self.kinds, precisions=self.precisions,
                           batch=self.batch)
        return select(nodes, self.select)

    def benchmark_config(self) -> BenchmarkConfig:
        return BenchmarkConfig(
            warmups=self.warmups, repetitions=self.repetitions,
            error_bound=self.error_bound, rigor=PlanRigor(self.rigor),
            seed=self.seed)

    # --- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        """Plain-data form: extents as '128x128' strings (the CLI syntax),
        sweeps as a list of tables, ``None`` fields omitted."""
        d: dict[str, Any] = {
            "clients": list(self.clients),
            "extents": [format_extents(e) for e in self.extents],
            "kinds": list(self.kinds),
            "precisions": list(self.precisions),
            "batch": self.batch,
            "rigor": self.rigor,
            "warmups": self.warmups,
            "repetitions": self.repetitions,
            "error_bound": self.error_bound,
            "seed": self.seed,
            "plan_cache": self.plan_cache,
            "verbose": self.verbose,
        }
        if self.load:
            d["load"] = list(self.load)
        if self.device_counts:   # omitted when empty, as in the reference
            d["device_counts"] = list(self.device_counts)
        for k in ("select", "wisdom", "costmodel", "output", "format"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.sweeps:
            d["sweep"] = [s.to_dict() for s in self.sweeps]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SuiteSpec":
        d = dict(d)
        sweeps = d.pop("sweep", None) or d.pop("sweeps", None) or ()
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown SuiteSpec key(s) {sorted(unknown)}; "
                             f"known: {', '.join(sorted(known | {'sweep'}))}")
        return cls(sweeps=tuple(SweepSpec.from_dict(s) if isinstance(s, dict)
                                else s for s in sweeps), **d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "SuiteSpec":
        return cls.from_dict(json.loads(text))

    def to_toml(self) -> str:
        """Emit the spec as TOML (scalar/array keys, then ``[[sweep]]``
        tables).  Hand-rolled writer: the standard library reads TOML but
        does not write it."""
        d = self.to_dict()
        sweeps = d.pop("sweep", [])
        lines = [f"{k} = {_toml_value(v)}" for k, v in d.items()]
        for s in sweeps:
            lines += ["", "[[sweep]]"]
            lines += [f"{k} = {_toml_value(v)}" for k, v in s.items()]
        return "\n".join(lines) + "\n"

    @classmethod
    def from_toml(cls, text: str) -> "SuiteSpec":
        return cls.from_dict(_toml_loads(text))

    def save(self, path: str) -> str:
        """Write the spec to ``path`` (TOML, or JSON for ``.json``)."""
        text = (self.to_json() if path.endswith(".json") else self.to_toml())
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
        return path

    @classmethod
    def from_file(cls, path: str) -> "SuiteSpec":
        with open(path) as f:
            text = f.read()
        if path.endswith(".json"):
            return cls.from_json(text)
        return cls.from_toml(text)


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return json.dumps(v)   # JSON string escaping is valid TOML
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"cannot serialize {type(v).__name__} to TOML: {v!r}")


def _toml_loads(text: str) -> dict:
    import tomllib
    return tomllib.loads(text)


# ---------------------------------------------------------------------------
# result sets
# ---------------------------------------------------------------------------
class ResultSet:
    """The materialized rows of one suite run + query/aggregation helpers."""

    def __init__(self, rows: Iterable[Row], columns: Sequence[str],
                 path: Optional[str] = None,
                 plan_stats: Optional[PlanCacheStats] = None):
        self.rows: list[Row] = list(rows)
        self.columns = list(columns)
        self.path = path              # file the run streamed to, if any
        self.plan_stats = plan_stats  # PlanCacheStats when caching was on

    # --- container protocol ------------------------------------------------
    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self) -> Iterator[Row]:
        return iter(self.rows)

    @property
    def n_rows(self) -> int:
        return len(self.rows)

    @property
    def n_failures(self) -> int:
        return sum(1 for r in self.rows if not r.success)

    # --- queries -----------------------------------------------------------
    def query(self, **eq) -> list[Row]:
        """Rows whose attributes equal every given keyword."""
        return [r for r in self.rows
                if all(getattr(r, k) == v for k, v in eq.items())]

    def failures(self) -> list[Row]:
        return [r for r in self.rows if not r.success]

    def aggregate(self, op: Optional[str] = None, percentiles: bool = False):
        """mean/stdev per (library, extents, precision, kind, rigor, op);
        ``percentiles=True`` adds p50/p95/p99 columns."""
        return aggregate_rows(self.rows, op, percentiles=percentiles)

    def aggregate_named(self, op: Optional[str] = None,
                        percentiles: bool = False) -> list[AggRow]:
        """The same grouping with named fields (``a.library``, ``a.mean``,
        ``a.p99``, ...): what the benchmark tables consume."""
        return aggregate_result_rows(self.rows, op, percentiles=percentiles)

    def summary(self, latency_op: str = "execute_forward") -> dict:
        """Planner-cost overview (paper Figs. 4-5): row/failure counts,
        aggregate planning time (the init ops), its cold share, and the
        plan-cache hit/miss totals, per-row markers plus the session-level
        stats.  When successful ``latency_op`` rows exist, also their
        mean and p50/p95/p99 (``"serve_request"`` for a service's rows)."""
        init_ops = ("init_forward", "init_inverse")
        plan_rows = [r for r in self.rows if r.op in init_ops]
        events = [r.plan_cache for r in plan_rows if r.plan_cache]
        total = sum(r.time_ms for r in plan_rows)
        if events:
            cold = sum(r.time_ms for r in plan_rows if r.plan_cache == "miss")
        else:
            # no hit/miss markers = plan cache off: every init op re-plans
            # and rebuilds, so the whole planning time is cold
            cold = total
        out = {
            "rows": self.n_rows,
            "failures": self.n_failures,
            "plan_time_ms": total,
            "plan_time_cold_ms": cold,
            "plan_cache_hits": sum(1 for e in events if e == "hit"),
            "plan_cache_misses": sum(1 for e in events if e == "miss"),
        }
        lat = [r.time_ms for r in self.rows
               if r.success and r.op == latency_op]
        if lat:
            out["latency_ms"] = {"op": latency_op, "n": len(lat),
                                 "mean": statistics.fmean(lat),
                                 **percentile_summary(lat)}
        if self.plan_stats is not None:
            out["plan_cache"] = self.plan_stats.as_dict()
        return out

    # --- export ------------------------------------------------------------
    def to_csv_string(self) -> str:
        return rows_to_csv(self.rows, self.columns)

    def save(self, path: str) -> str:
        save_csv(path, self.rows, self.columns)
        self.path = path
        return path

    @classmethod
    def concat(cls, results: Sequence["ResultSet"]) -> "ResultSet":
        """Merge runs that share a schema into one result set."""
        if not results:
            return cls([], columns_for(False))
        cols = results[0].columns
        for r in results[1:]:
            if r.columns != cols:
                raise ValueError("cannot concat ResultSets with different "
                                 f"columns: {cols} vs {r.columns}")
        return cls([row for r in results for row in r.rows], cols,
                   path=results[0].path)


class _CollectorSink(ResultSink):
    """In-memory sink feeding a ResultSet."""

    def __init__(self, columns):
        super().__init__(path="", columns=columns)
        self.rows: list[Row] = []

    def _write(self, row: Row) -> None:
        self.rows.append(row)


class _TeeSink(ResultSink):
    """Forward every row to several sinks (memory + streaming file)."""

    def __init__(self, sinks: Sequence[ResultSink]):
        super().__init__(path="", columns=sinks[0].columns)
        self.sinks = list(sinks)

    def _write(self, row: Row) -> None:
        for s in self.sinks:
            s.add(row)

    def save(self) -> str:
        for s in self.sinks:
            s.save()
        return self.path


# ---------------------------------------------------------------------------
# the session facade
# ---------------------------------------------------------------------------
class Session:
    """Owns what a run needs besides its description: the device context,
    the wisdom store, the plan cache and the result sinks.  Reusing one
    Session across ``run`` calls shares the plan cache."""

    def __init__(self, context: Optional[TorchContext] = None,
                 plan_cache: Optional[PlanCache] = None,
                 wisdom: Optional[Wisdom] = None):
        self.context = context if context is not None else TorchContext()
        self._plan_cache = plan_cache
        self._wisdom = wisdom
        self._device_kind: Optional[str] = None

    @property
    def device_kind(self) -> str:
        """The context's device kind (``"cpu"`` or the card's name): the
        key wisdom records and cost tables are stored under."""
        if self._device_kind is None:
            self._device_kind = self.context.discover_kind()
        return self._device_kind

    @property
    def plan_cache(self) -> PlanCache:
        """The session-lifetime plan cache (created on first use)."""
        if self._plan_cache is None:
            self._plan_cache = PlanCache()
        return self._plan_cache

    def _resolve_wisdom(self, spec: SuiteSpec) -> Optional[Wisdom]:
        if self._wisdom is not None:
            return self._wisdom
        if spec.wisdom:
            return Wisdom(spec.wisdom, device_kind=self.device_kind)
        return None

    def run(self, spec: SuiteSpec,
            nodes: Optional[Sequence[BenchNode]] = None) -> ResultSet:
        """Execute the spec; returns the materialized :class:`ResultSet`.

        ``nodes`` overrides the spec's own tree (the CLI pre-builds it to
        report empty selections before any device work happens).  A
        cost-model table named by the spec is the active model for the
        run; wisdom is saved after a MEASURE or PATIENT run."""
        if nodes is None:
            nodes = spec.build_nodes()
        else:
            spec.load_modules()
        cache = self.plan_cache if spec.plan_cache else None
        wisdom = self._resolve_wisdom(spec)
        columns = columns_for(cache is not None,
                              plan_source=wisdom is not None)
        collector = _CollectorSink(columns)
        sinks: list[ResultSink] = [collector]
        if spec.output:
            sinks.append(open_sink(spec.output, fmt=spec.format,
                                   columns=columns))
        writer = _TeeSink(sinks)
        if spec.costmodel:
            from .costmodel import model_for_device, use_model
            model_cm = use_model(model_for_device(self.device_kind,
                                                  spec.costmodel))
        else:
            model_cm = nullcontext()
        try:
            with model_cm:
                run_nodes(nodes, context=self.context,
                          config=spec.benchmark_config(), writer=writer,
                          plan_cache=cache, wisdom=wisdom,
                          verbose=spec.verbose)
        finally:
            writer.save()
        # in a group of ranks (the distributed clients' SPMD runs) every
        # rank holds the same selections, and rank 0 writes them
        if wisdom is not None and spec.rigor in (PlanRigor.MEASURE.value,
                                                 PlanRigor.PATIENT.value) \
                and not (dist.is_initialized() and dist.get_rank() != 0):
            wisdom.save()
        return ResultSet(collector.rows, columns,
                         path=spec.output if spec.output else None,
                         plan_stats=cache.stats if cache else None)


def run_suite(spec: SuiteSpec, session: Optional[Session] = None) -> ResultSet:
    """Run ``spec`` in a fresh Session (on ``cuda:0``) or the given one."""
    return (session if session is not None else Session()).run(spec)


# ---------------------------------------------------------------------------
# support matrix
# ---------------------------------------------------------------------------
#: Power-of-two probe extents per rank that answer "does this backend take
#: rank r at all?"; extent-dependent caps (one block's capacity, smoothness)
#: still apply to single problems through ``backend_supports``.
SUPPORT_PROBE_EXTENTS = {1: (16,), 2: (8, 16), 3: (4, 4, 8)}


def support_matrix(kinds: Sequence[str] = KINDS,
                   precisions: Sequence[str] = PRECISIONS,
                   probes: Optional[dict] = None) -> list[dict]:
    """The backend x kind x rank x precision feasibility table: one row
    per cell, ``{"backend", "kind", "precision", "rank", "extents",
    "supported"}``, over the planner's ``BACKENDS``."""
    from .candidates import BACKENDS, backend_supports
    from .client import Problem

    probes = dict(SUPPORT_PROBE_EXTENTS if probes is None else probes)
    rows = []
    for backend in BACKENDS:
        for rank, extents in sorted(probes.items()):
            for kind in kinds:
                for precision in precisions:
                    problem = Problem(tuple(extents), kind, precision)
                    rows.append({
                        "backend": backend, "kind": kind,
                        "precision": precision, "rank": rank,
                        "extents": tuple(extents),
                        "supported": backend_supports(backend, problem),
                    })
    return rows


def dist_support_matrix(device_counts: Sequence[int] = (2, 4, 8),
                        kinds: Sequence[str] = KINDS,
                        probes: Optional[dict] = None) -> list[dict]:
    """The decomposition x kind x rank x device-count table: ``dist1d`` and
    ``slab`` over the P ranks flat, ``pencil`` over the most balanced
    (Pr, Pc) factorization, as the planner enumerates them."""
    from .candidates import DIST_BACKENDS, _pencil_mesh_shapes, dist_supports
    from .client import Problem

    probes = dict(SUPPORT_PROBE_EXTENTS if probes is None else probes)
    rows = []
    for backend in DIST_BACKENDS:
        for devices in device_counts:
            for rank, extents in sorted(probes.items()):
                for kind in kinds:
                    if backend == "pencil":
                        shapes = _pencil_mesh_shapes(devices) or [(devices,)]
                        mesh_shape = shapes[0]
                    else:
                        mesh_shape = (devices,)
                    problem = Problem(tuple(extents), kind, "float")
                    rows.append({
                        "backend": backend, "kind": kind, "rank": rank,
                        "devices": devices, "extents": tuple(extents),
                        "supported": dist_supports(backend, problem,
                                                   mesh_shape),
                    })
    return rows


__all__ = ["SweepSpec", "SuiteSpec", "ResultSet", "Session", "run_suite",
           "SWEEP_CLASSES", "SUPPORT_PROBE_EXTENTS", "support_matrix",
           "dist_support_matrix"]
