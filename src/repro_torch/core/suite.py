"""Suite descriptions + the Session facade.

* :class:`SuiteSpec`: a frozen description of one benchmark run with
  explicit extents: clients, extents, kinds, precisions, batch, planner rigor, warmups, repetitions, error
  bound, seed, plan-cache policy, wisdom path, cost-model table, output,
  verbosity.
* :class:`Session`: owns the device context, the wisdom store, the
  (shareable) plan cache and the result sinks.  ``Session.run(spec)``
  returns a :class:`ResultSet`; :func:`run_suite` runs one spec in a
  fresh (or given) Session.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

from .benchmark import BenchmarkConfig, run_nodes
from .compare import AggRow, aggregate_result_rows
from .client import KINDS, PRECISIONS, TorchContext
from .extents import format_extents, parse_extents
from .plan import PlanCache, PlanRigor
from .registry import get_client
from .results import (ResultSink, Row, aggregate_rows, columns_for,
                      open_sink)
from .tree import BenchNode, build_tree
from .wisdom import Wisdom


def _as_extent(v) -> tuple[int, ...]:
    if isinstance(v, str):
        return parse_extents(v)
    if isinstance(v, int):
        return (v,)
    return parse_extents(format_extents(tuple(int(x) for x in v)))


@dataclass(frozen=True)
class SuiteSpec:
    """A complete description of one benchmark run over explicit extents."""

    clients: tuple[str, ...] = ("TorchFFT",)
    extents: tuple[tuple[int, ...], ...] = ()
    kinds: tuple[str, ...] = KINDS
    precisions: tuple[str, ...] = ("float",)
    batch: int = 1
    rigor: str = "estimate"
    warmups: int = 1
    repetitions: int = 3
    error_bound: float = 1e-5
    seed: int = 2017
    plan_cache: bool = True
    wisdom: Optional[str] = None                # wisdom JSON path
    costmodel: Optional[str] = None             # coefficient table path
    output: Optional[str] = "result.csv"        # None = in-memory only
    verbose: bool = False

    def __post_init__(self):
        norm = object.__setattr__
        norm(self, "clients", tuple(str(c) for c in self.clients))
        norm(self, "extents", tuple(_as_extent(e) for e in self.extents))
        norm(self, "kinds", tuple(self.kinds))
        norm(self, "precisions", tuple(self.precisions))
        if isinstance(self.rigor, PlanRigor):
            norm(self, "rigor", self.rigor.value)
        if self.rigor not in {r.value for r in PlanRigor}:
            raise ValueError(f"unknown rigor {self.rigor!r}; known: "
                             f"{[r.value for r in PlanRigor]}")
        bad = set(self.kinds) - set(KINDS)
        if bad:
            raise ValueError(f"unknown kind(s) {sorted(bad)}; known: {KINDS}")
        bad = set(self.precisions) - set(PRECISIONS)
        if bad:
            raise ValueError(
                f"unknown precision(s) {sorted(bad)}; known: {PRECISIONS}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.warmups < 0 or self.repetitions < 0:
            raise ValueError("warmups/repetitions must be >= 0")

    def build_nodes(self) -> list[BenchNode]:
        """Materialize the benchmark tree this spec describes."""
        from .clients import torch_fft  # noqa: F401  (registers the clients)
        if not self.extents:
            raise ValueError("spec has no extents")
        return build_tree([get_client(c) for c in self.clients], self.extents,
                          kinds=self.kinds, precisions=self.precisions,
                          batch=self.batch)

    def benchmark_config(self) -> BenchmarkConfig:
        return BenchmarkConfig(
            warmups=self.warmups, repetitions=self.repetitions,
            error_bound=self.error_bound, rigor=PlanRigor(self.rigor),
            seed=self.seed)


class ResultSet:
    """The materialized rows of one suite run + query helpers."""

    def __init__(self, rows: Iterable[Row], columns: Sequence[str]):
        self.rows: list[Row] = list(rows)
        self.columns = list(columns)

    def query(self, **eq) -> list[Row]:
        """Rows whose attributes equal every given keyword."""
        return [r for r in self.rows
                if all(getattr(r, k) == v for k, v in eq.items())]

    def failures(self) -> list[Row]:
        return [r for r in self.rows if not r.success]

    def aggregate(self, op: Optional[str] = None):
        """mean/stdev per (library, extents, precision, kind, rigor, op)."""
        return aggregate_rows(self.rows, op)

    def aggregate_named(self, op: Optional[str] = None) -> list[AggRow]:
        """The same grouping with named fields (``a.library``, ``a.mean``,
        ...): what the benchmark tables consume."""
        return aggregate_result_rows(self.rows, op)


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
        """Execute the spec (or the given ``nodes``); returns the rows.
        A cost-model table named by the spec is the active model for the
        run; wisdom is saved after a MEASURE or PATIENT run."""
        if nodes is None:
            nodes = spec.build_nodes()
        cache = self.plan_cache if spec.plan_cache else None
        wisdom = self._resolve_wisdom(spec)
        columns = columns_for(cache is not None,
                              plan_source=wisdom is not None)
        collector = _CollectorSink(columns)
        sinks: list[ResultSink] = [collector]
        if spec.output:
            sinks.append(open_sink(spec.output, columns=columns))
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
        if wisdom is not None and spec.rigor in (PlanRigor.MEASURE.value,
                                                 PlanRigor.PATIENT.value):
            wisdom.save()
        return ResultSet(collector.rows, columns)


def run_suite(spec: SuiteSpec, session: Optional[Session] = None) -> ResultSet:
    """Run ``spec`` in a fresh Session (on ``cuda:0``) or the given one."""
    return (session if session is not None else Session()).run(spec)
