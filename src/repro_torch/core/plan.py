"""Plans, plan rigors and the plan cache.

A plan is a (backend, knobs) choice for one Problem plus the device state
its build produced (for the Stockham kernel: the schedule's twiddles on the
card).  Only FFTW_ESTIMATE exists in this slice: a client pinned to one
backend takes that backend with its default knobs.  The other rigors raise
``NotImplementedError``, which the suite records as a failed node.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

from .candidates import Candidate
from .client import Problem


class PlanRigor(enum.Enum):
    ESTIMATE = "estimate"
    MEASURE = "measure"
    PATIENT = "patient"
    WISDOM_ONLY = "wisdom_only"


@dataclass
class Plan:
    problem: Problem
    candidate: Candidate
    rigor: PlanRigor
    plan_time_ms: float = 0.0


def make_plan(problem: Problem, rigor: PlanRigor, backend: str) -> Plan:
    """ESTIMATE for a client pinned to ``backend``."""
    if rigor is not PlanRigor.ESTIMATE:
        raise NotImplementedError("planner: later slice")
    t0 = time.perf_counter()
    return Plan(problem, Candidate(backend), rigor,
                (time.perf_counter() - t0) * 1e3)


@dataclass
class PlanCacheStats:
    """Cold/warm accounting: misses pay the measured build (cold), hits
    reuse the built plan (warm)."""

    hits: int = 0
    misses: int = 0
    cold_ms: float = 0.0   # total time spent building on misses


class PlanCache:
    """Memoizes built plans (executables) and plan selections.

    Keys hold the device kind, the problem signature, the candidate and the
    direction.  Without the cache every repetition rebuilds (the per-run
    planning measurement of paper Figs. 4-5); with it, the first run to need
    a plan pays the measured cold build and later runs reuse it, and result
    rows carry a ``plan_cache`` hit/miss marker.

    Lookups are concurrency-safe and builds single-flight: when several
    threads race on one cold key, one builds and the rest wait and hit.
    """

    def __init__(self) -> None:
        self._execs: dict[str, Any] = {}
        self._plans: dict[str, Any] = {}
        self._lock = threading.Lock()
        self._inflight: dict[str, threading.Event] = {}
        self.stats = PlanCacheStats()

    def _single_flight(self, table: dict, kind: str, key: str,
                       build: Callable[[], Any],
                       count_stats: bool) -> tuple[Any, str, float]:
        flight_key = f"{kind}|{key}"
        while True:
            with self._lock:
                if key in table:
                    if count_stats:
                        self.stats.hits += 1
                    return table[key], "hit", 0.0
                ev = self._inflight.get(flight_key)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[flight_key] = ev
                    break           # this thread builds the key
            ev.wait()               # another thread is building this key
        t0 = time.perf_counter()
        try:
            built = build()
            ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                table[key] = built
                if count_stats:
                    self.stats.misses += 1
                    self.stats.cold_ms += ms
            return built, "miss", ms
        finally:
            with self._lock:
                self._inflight.pop(flight_key, None)
            ev.set()

    @staticmethod
    def executable_key(device_kind: str, problem: Problem,
                       candidate: "Candidate | str", direction: str) -> str:
        ck = candidate.key() if isinstance(candidate, Candidate) else str(candidate)
        return f"exec|{device_kind}|{problem.signature()}|{ck}|{direction}"

    @staticmethod
    def plan_key(device_kind: str, problem: Problem, rigor: PlanRigor,
                 scope: str = "") -> str:
        return f"plan|{device_kind}|{problem.signature()}|{rigor.value}|{scope}"

    def executable(self, key: str, build: Callable[[], Any]
                   ) -> tuple[Any, str, float]:
        """``(built, 'hit'|'miss', elapsed_ms)``; ``build`` runs on a miss."""
        return self._single_flight(self._execs, "exec", key, build,
                                   count_stats=True)

    def plan(self, key: str, make: Callable[[], Any]) -> tuple[Any, str]:
        """Memoized plan selection."""
        plan, event, _ = self._single_flight(self._plans, "plan", key, make,
                                             count_stats=False)
        return plan, event


def cached_build(plan_cache: PlanCache | None, events: dict, op_name: str,
                 key: str, build: Callable[[], Any]):
    """Memoize-or-build, recording the hit/miss event for the result rows.
    With no cache attached this is just ``build()``."""
    if plan_cache is None:
        return build()
    built, event, _ = plan_cache.executable(key, build)
    events[op_name] = event
    return built
