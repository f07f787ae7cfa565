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
carries ``plan_time_ms``.

Fault tolerance: with a ``build`` and a :class:`CircuitBreaker`,
:func:`make_plan` walks :func:`fallback_chain`, building each candidate
before it returns it (:func:`walk_fallback_chain`, the serve engine's walk
too; on a card only an injected fault demotes, :func:`is_kernel_fault`);
wisdom's demotion records steer every rigor away from a known-bad pick.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .breaker import (CircuitBreaker, breaker_key,  # noqa: F401  (re-exported)
                      problem_class)
from .candidates import Candidate, candidates
from .candidates import (  # noqa: F401  (re-exported, as the reference's)
    DIST_A2A_COUNT, DIST_BACKENDS, DIST_NATURAL_EXTRA, _dist_candidates,
    _mesh_devices, _pencil_mesh_shapes, dist_local_lengths, dist_supports)
from .client import Problem
from .costmodel import dist_local_engine  # noqa: F401  (re-exported)
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
    #: warm start) | 'fallback' (the fault-tolerant walk demoted past a
    #: candidate).  Result rows carry it as ``plan_source``.
    source: str = ""
    #: Candidate keys the fault-tolerant walk skipped or saw fail.
    fallbacks: tuple[str, ...] = ()


@dataclass
class PlanCacheStats:
    """Cold/warm accounting: misses pay the measured build (cold), hits
    reuse the built plan (warm)."""

    hits: int = 0
    misses: int = 0
    cold_ms: float = 0.0   # total time spent building on misses

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "cold_ms": self.cold_ms}


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

    def __len__(self) -> int:
        with self._lock:
            return len(self._execs)


def cached_build(plan_cache: PlanCache | None, events: dict, op_name: str,
                 key: str, build: Callable[[], Any]):
    """Memoize-or-build, recording the hit/miss event for the result rows.
    With no cache attached this is just ``build()``."""
    if plan_cache is None:
        return build()
    built, event, _ = plan_cache.executable(key, build)
    events[op_name] = event
    return built


def executable_bytes(built) -> int:
    """Bytes attributable to a built transform (the plan-size analogue):
    the device tables its plan holds, ``Transform.plan_bytes``."""
    return int(getattr(built, "plan_bytes", 0))


def fallback_chain(problem: Problem, patient: bool = False) -> list[Candidate]:
    """The ordered degradation path: ESTIMATE's pick first (its dft pin
    included), then every other feasible candidate by ascending modeled
    cost under the active cost model, with a plain ``xla`` candidate
    guaranteed present: the always-feasible terminal fallback.  The
    walkers (:func:`make_plan`'s fault-tolerant mode, the serve engine)
    apply wisdom demotions and the circuit breaker at try time."""
    cands = candidates(problem, patient=patient)
    scored = [(estimate_bytes_moved(problem, c), i, c)
              for i, c in enumerate(cands)]
    ranked = [c for cost, _, c in sorted(scored, key=lambda t: t[:2])
              if cost != float("inf")]
    top = estimate_choice(problem)
    chain = [top] + [c for c in ranked if c.key() != top.key()]
    if not any(c.backend == "xla" and not c.axes for c in chain):
        chain.append(Candidate("xla"))
    return chain


def probe_finite(fn: Callable, problem: Problem, device="cpu") -> None:
    """Cheap output-finiteness probe: push one all-ones batch through a
    freshly built transform on ``device`` and reject it on any non-finite
    output: the 'builds fine, computes garbage' failure a build error
    misses."""
    x = torch.ones((problem.batch, *problem.extents),
                   dtype=torch.float64 if problem.precision == "double"
                   else torch.float32, device=device)
    if problem.complex_input:
        x = x.to(torch.complex128 if problem.precision == "double"
                 else torch.complex64)
    out = fn(x)
    if not torch.is_tensor(out):
        out = torch.as_tensor(np.asarray(out))
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError(
            f"finiteness probe failed for {problem.signature()}: "
            f"the transform produced non-finite output")


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


def is_kernel_fault(err: BaseException, on_card: bool) -> bool:
    """Whether a candidate's failure is a hand-written kernel's own, which
    no walk demotes past: on a card, every failure but an injected one
    (``FaultInjected``), so that a kernel that does not build or launch
    fails and names itself rather than being served by torch.fft.  On the
    CPU, where every candidate runs its plain version, any failure demotes,
    as in the reference."""
    if not on_card:
        return False
    from ..serve.faults import FaultInjected
    return not isinstance(err, FaultInjected)


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, launch or pass the
    finiteness probe on the card: the fault-tolerant walk raises it rather
    than demoting past the kernel."""

    def __init__(self, cand: Candidate, problem: Problem, err: BaseException):
        super().__init__(
            f"kernel {cand.backend} ({cand.key()}) failed for "
            f"{problem.signature()}: {type(err).__name__}: {err}")


def walk_fallback_chain(
        problem: Problem, chain: Sequence[Candidate],
        build: Callable[[Candidate], Any], breaker: CircuitBreaker, *,
        demoted: frozenset = frozenset(),
        kernel_error: Callable[[Candidate, Exception], Exception | None]
        = lambda cand, err: None,
        on_failure: Callable[[Candidate, bool], None] = lambda c, o: None,
        record_success: bool = True) -> tuple[Candidate, Any, tuple]:
    """The fault-tolerant walk of ``chain`` (:func:`fallback_chain`) that
    both :func:`make_plan` and the serve engine take: skip a wisdom-demoted
    or quarantined candidate without building it, build the others in
    order and return the first that builds, as ``(candidate, built,
    skipped or failed keys)``.  The terminal candidate (a plain ``xla`` is
    always in the chain) is tried whatever its quarantine state.

    A failure for which ``kernel_error(cand, err)`` returns an exception
    is a kernel's own (:func:`is_kernel_fault`): that exception is raised
    and nothing is booked.  Any other failure is recorded against the
    breaker and reported as ``on_failure(cand, opened)``, ``opened`` true
    where it opened the breaker of a candidate other than a plain ``xla``
    (a demotion to persist), and the walk moves on."""
    fallbacks: list[str] = []
    last_err: Exception | None = None
    for i, cand in enumerate(chain):
        terminal = i == len(chain) - 1
        is_xla = cand.backend == "xla" and not cand.axes
        bkey = breaker_key(cand.backend, problem)
        if not terminal and not is_xla \
                and (cand.backend in demoted or not breaker.allows(bkey)):
            fallbacks.append(cand.key())
            continue
        try:
            built = build(cand)
        except Exception as e:
            fault = kernel_error(cand, e)
            if fault is not None:
                raise fault from e
            last_err = e
            opened = breaker.record_failure(bkey) == CircuitBreaker.OPEN
            on_failure(cand, opened and not is_xla)
            fallbacks.append(cand.key())
            continue
        if record_success:
            breaker.record_success(bkey)
        return cand, built, tuple(fallbacks)
    raise RuntimeError(
        f"no feasible plan for {problem.signature()}: all {len(chain)} "
        f"candidates failed (last: {type(last_err).__name__}: {last_err})"
    ) from last_err


def _fallback_plan(problem: Problem, rigor: PlanRigor,
                   build: Callable[[Candidate], Callable], wisdom,
                   breaker: CircuitBreaker, probe: bool, device, t0: float,
                   demoted: frozenset) -> Plan:
    """Fault-tolerant planning: :func:`walk_fallback_chain` over the
    cost-ordered chain, each candidate built and (with ``probe``) probed
    for finite output on ``device``; a demotion that opens the breaker is
    persisted to wisdom.  On a card a kernel's own failure raises
    :class:`KernelError`."""
    on_card = torch.device(device).type == "cuda"

    def built(cand: Candidate) -> Callable:
        fn = build(cand)
        if probe:
            probe_finite(fn, problem, device)
        return fn

    def kernel_error(cand: Candidate, err: Exception):
        return (KernelError(cand, problem, err)
                if is_kernel_fault(err, on_card) else None)

    def on_failure(cand: Candidate, opened: bool) -> None:
        if opened and wisdom is not None:
            wisdom.record_demotion(problem, cand.backend)

    cand, _, fallbacks = walk_fallback_chain(
        problem, fallback_chain(problem, patient=(rigor is PlanRigor.PATIENT)),
        built, breaker, demoted=demoted, kernel_error=kernel_error,
        on_failure=on_failure)
    return Plan(problem, cand, rigor, (time.perf_counter() - t0) * 1e3,
                fallbacks=fallbacks,
                source="fallback" if fallbacks else "estimate")


def make_plan(problem: Problem, rigor: PlanRigor,
              build: Callable[[Candidate], Callable] | None = None,
              wisdom=None, device=None, near: bool = True,
              breaker: CircuitBreaker | None = None,
              probe: bool = False) -> Plan | None:
    """The planner.  Returns None for a WISDOM_ONLY miss (fftw's NULL
    plan).

    MEASURE/PATIENT consult wisdom first: a persisted selection for this
    (device, problem) skips the sweep, and on an exact miss the
    nearest-neighbor warm start does (plan source ``wisdom_near``).
    ``near=False`` turns the nearest-neighbor path off, so that a
    pregeneration run gives every swept shape a real sweep rather than
    its neighbor's pick.
    Otherwise they time every candidate that ``build``
    makes on ``device`` (default ``cuda:0``) and record the winner in
    wisdom.  Without ``build`` they take ESTIMATE's pick untimed, which is
    never recorded.  A wisdom-demoted ESTIMATE pick gives way to the next
    candidate of :func:`fallback_chain`.

    Fault tolerance: with both ``build`` and ``breaker``, planning walks
    :func:`fallback_chain` instead (:func:`_fallback_plan`): each
    candidate is built (and, with ``probe=True``, probed for finite output
    on ``device``) before it is returned, and a failure demotes to the
    next candidate by modeled cost.  On a card (``device`` defaults to
    ``cuda:0``) only an injected fault demotes: a hand-written kernel's
    own failure raises :class:`KernelError`, naming the kernel.
    """
    t0 = time.perf_counter()
    ms = lambda: (time.perf_counter() - t0) * 1e3
    if rigor is PlanRigor.WISDOM_ONLY:
        if wisdom is None:
            return None
        cand = wisdom.lookup(problem)
        if cand is not None:
            return Plan(problem, cand, rigor, ms(), source="wisdom")
        if near:
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
        if cand is None and near:
            cand = _near_lookup(wisdom, problem, demoted)
            if cand is not None:
                return Plan(problem, cand, rigor, ms(), source="wisdom_near")

    if build is not None and breaker is not None:
        return _fallback_plan(problem, rigor, build, wisdom, breaker, probe,
                              torch.device("cuda", 0) if device is None
                              else device, t0, demoted)

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
