"""Plans, plan rigors, the planner and the plan cache.

fftw's planner concept (paper §2.1) as the reference package maps it:

  plan             = (backend, knobs) for one Problem, plus the device
                     state its build produced (the kernels' tables)
  FFTW_ESTIMATE    = the bytes-moved cost model over the candidate space
                     (:mod:`.costmodel`), no timing
  FFTW_MEASURE     = build and time every candidate on the device, keep
                     the fastest
  FFTW_PATIENT     = MEASURE over the space widened by the kernels' knobs
  FFTW_WISDOM_ONLY = a persisted choice (:mod:`.wisdom`), or no plan

Planning time is a measurement of its own (paper Figs. 4-5): every plan
carries ``plan_time_ms``.  The reference's fault-tolerant planning (the
circuit breaker walking the fallback chain) comes with the serving slice;
wisdom's demotion records already steer ESTIMATE away from a known-bad
pick here.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .candidates import Candidate, candidates
from .client import Problem
from .costmodel import estimate_bytes_moved, estimate_choice


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
    measured_ms: dict[str, float] = field(default_factory=dict)  # per candidate
    #: Where the selection came from: 'estimate' | 'measure' | 'patient' |
    #: 'wisdom' (exact persisted hit) | 'wisdom_near' (nearest-neighbor
    #: warm start).  Result rows carry it as ``plan_source``.
    source: str = ""


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


def fallback_chain(problem: Problem, patient: bool = False) -> list[Candidate]:
    """The ordered degradation path: ESTIMATE's pick first (its dft pin
    included), then every other feasible candidate by ascending modeled
    cost.  ``xla`` is always among them: it is feasible for every
    problem."""
    cands = candidates(problem, patient=patient)
    scored = [(estimate_bytes_moved(problem, c), i, c)
              for i, c in enumerate(cands)]
    ranked = [c for cost, _, c in sorted(scored, key=lambda t: t[:2])
              if cost != float("inf")]
    top = estimate_choice(problem)
    return [top] + [c for c in ranked if c.key() != top.key()]


def measure_input(problem: Problem, device) -> torch.Tensor:
    """MEASURE's input: the reference's ``default_rng(0)`` normal batch,
    on ``device``."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((problem.batch, *problem.extents)).astype(
        problem.real_dtype)
    if problem.complex_input:
        x = x.astype(problem.input_dtype)
    return torch.from_numpy(x).to(device)


def measure_plan(problem: Problem, build: Callable[[Candidate], Callable],
                 cands: Sequence[Candidate], device, reps: int = 3
                 ) -> tuple[Candidate, dict[str, float]]:
    """MEASURE: build and run each candidate on ``device`` (one warm call,
    then the best of ``reps`` timed calls, each ending in a device
    synchronize); returns the fastest and the timing table.

    On the CPU, where every candidate runs its plain version, a candidate
    that raises is recorded as NaN, as in the reference.  On any other
    device a raise is a kernel that did not build or launch: it propagates,
    so the node fails and names it, and no other candidate takes its
    place."""
    device = torch.device(device)
    sync = ((lambda: torch.cuda.synchronize(device))
            if device.type == "cuda" else (lambda: None))
    xd = measure_input(problem, device)
    timings: dict[str, float] = {}
    for cand in cands:
        try:
            fn = build(cand)
            fn(xd)
            sync()
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                fn(xd)
                sync()
                best = min(best, (time.perf_counter() - t0) * 1e3)
            timings[cand.key()] = best
        except Exception:
            if device.type != "cpu":
                raise
            timings[cand.key()] = float("nan")
    feasible = {k: v for k, v in timings.items() if v == v}
    if not feasible:
        raise RuntimeError(f"no feasible plan for {problem.signature()}")
    best_key = min(feasible, key=feasible.get)
    return next(c for c in cands if c.key() == best_key), timings


def _demoted_backends(wisdom, problem: Problem) -> frozenset:
    """Backends wisdom has quarantined for this problem class."""
    return wisdom.demoted(problem) if wisdom is not None else frozenset()


def _near_lookup(wisdom, problem: Problem, demoted: frozenset):
    """Nearest-neighbor wisdom: a candidate tuned for the closest
    same-feasibility-class shape, or None."""
    hit = wisdom.lookup_near(problem)
    if hit is None:
        return None
    cand, _neighbor = hit
    if cand.backend in demoted and cand.backend != "xla":
        return None
    return cand


def make_plan(problem: Problem, rigor: PlanRigor,
              build: Callable[[Candidate], Callable] | None = None,
              wisdom=None, device=None) -> Plan | None:
    """The planner.  Returns None for a WISDOM_ONLY miss (fftw's NULL
    plan).

    MEASURE/PATIENT consult wisdom first: a persisted selection for this
    (device, problem) skips the sweep, and on an exact miss the
    nearest-neighbor warm start does (plan source ``wisdom_near``).
    Otherwise they time every candidate that ``build``
    makes on ``device`` (default ``cuda:0``) and record the winner in
    wisdom.  Without ``build`` they take ESTIMATE's pick untimed, which is
    never recorded.  A wisdom-demoted ESTIMATE pick gives way to the next
    candidate of :func:`fallback_chain`.
    """
    t0 = time.perf_counter()
    ms = lambda: (time.perf_counter() - t0) * 1e3
    if rigor is PlanRigor.WISDOM_ONLY:
        if wisdom is None:
            return None
        cand = wisdom.lookup(problem)
        if cand is not None:
            return Plan(problem, cand, rigor, ms(), source="wisdom")
        cand = _near_lookup(wisdom, problem,
                            _demoted_backends(wisdom, problem))
        if cand is not None:
            return Plan(problem, cand, rigor, ms(), source="wisdom_near")
        return None

    demoted = _demoted_backends(wisdom, problem)
    if wisdom is not None and rigor in (PlanRigor.MEASURE, PlanRigor.PATIENT):
        cand = wisdom.lookup(problem)
        if cand is not None and cand.backend not in demoted:
            return Plan(problem, cand, rigor, ms(), source="wisdom")
        if cand is None:
            cand = _near_lookup(wisdom, problem, demoted)
            if cand is not None:
                return Plan(problem, cand, rigor, ms(), source="wisdom_near")

    if rigor is PlanRigor.ESTIMATE or build is None:
        cand, timings = estimate_choice(problem), {}
        if cand.backend in demoted and cand.backend != "xla":
            cand = next(c for c in fallback_chain(problem)
                        if c.backend == "xla" or c.backend not in demoted)
    else:
        cands = candidates(problem, patient=(rigor is PlanRigor.PATIENT))
        if demoted:
            cands = [c for c in cands
                     if c.backend == "xla" or c.backend not in demoted]
        cand, timings = measure_plan(
            problem, build, cands,
            torch.device("cuda", 0) if device is None else device)
    plan = Plan(problem, cand, rigor, ms(), timings,
                source=rigor.value if timings else "estimate")
    # persist only selections a sweep timed: an untimed pick recorded as
    # if measured would short-circuit every later sweep
    if wisdom is not None and timings \
            and rigor in (PlanRigor.MEASURE, PlanRigor.PATIENT):
        wisdom.record(problem, cand, measured_ms=timings.get(cand.key()),
                      rigor=rigor.value)
    return plan
