"""Deterministic fault injection for the planner and the serve engine.

A production FFT service meets failures the offline suite never sees: a
backend whose kernel won't compile for some extent, an executable that
raises (or silently emits NaNs) on device, a stalled host↔device transfer,
a worker thread that dies mid-batch.  Reproducing those against real
hardware is flaky by construction, so this module makes every failure mode
*injectable and seeded*: a :class:`FaultPlan` is a small, declarative
registry of :class:`FaultRule`\\ s, matched by (site, backend, extents,
kind, request id, nth matching call), that the serve engine and the
planner's build path consult at well-defined injection points.

Sites (where a rule can fire):

    build      the executable compile path (``FFTService._executable`` /
               a wrapped ``make_plan`` build callable)
    dispatch   host staging + device upload (``FFTService._dispatch``)
    execute    device completion / result fetch (``FFTService._retire``)

Fault kinds and their effect at the injection point:

    compile_error    raise :class:`FaultInjected` from the build
    execute_error    raise :class:`FaultInjected` at retire
    nan_output       corrupt the batch (or one request's rows) with NaNs
    transfer_stall   sleep ``stall_ms`` in the dispatch path
    latency_spike    sleep ``stall_ms`` at retire (slow batch, no error)
    kill_worker      raise :class:`WorkerKilled` (a BaseException that
                     escapes the engine's per-batch error handling and
                     kills the worker thread — the watchdog's test case)

Determinism: matching is pure bookkeeping — each rule counts the calls it
matches and fires on calls ``after <= n < after + times`` (``times = -1``
means forever).  The same request tape against the same plan fires the
same faults; there is no randomness anywhere in the hot path.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, fields
from typing import Optional, Sequence


class FaultInjected(RuntimeError):
    """An injected failure (compile or execute site).  Deliberately an
    ordinary ``Exception`` so it exercises exactly the handling paths a
    real backend failure would."""

    retryable = True


class WorkerKilled(BaseException):
    """An injected worker death.  Derives from ``BaseException`` so it
    escapes the engine's ``except Exception`` batch handling the way a
    real thread-killing condition would, leaving in-flight requests for
    the watchdog to fail."""


#: Every injectable failure mode, mapped to the site where it fires.
FAULT_SITES = {
    "compile_error": "build",
    "execute_error": "execute",
    "nan_output": "execute",
    "transfer_stall": "dispatch",
    "latency_spike": "execute",
    "kill_worker": "dispatch",
}
FAULT_KINDS = tuple(FAULT_SITES)


@dataclass(frozen=True)
class FaultRule:
    """One injectable failure, matched by coordinates + nth-call window.

    ``backend='*'`` / ``kind='*'`` / ``extents=None`` / ``rid=None`` are
    wildcards.  ``rid`` pins a rule to one specific request — the "poison
    request" the batch-bisection machinery must isolate.
    """

    fault: str                         # one of FAULT_KINDS
    backend: str = "*"                 # backend key or '*'
    extents: Optional[tuple[int, ...]] = None   # transform extents or any
    kind: str = "*"                    # FFT kind (Outplace_Complex, ...)
    rid: Optional[int] = None          # pin to one request id (poison)
    after: int = 0                     # skip the first `after` matches
    times: int = -1                    # fire this many times (-1 = forever)
    stall_ms: float = 25.0             # sleep for stall/latency faults

    def __post_init__(self):
        if self.fault not in FAULT_SITES:
            raise ValueError(f"unknown fault {self.fault!r}; "
                             f"known: {FAULT_KINDS}")
        if self.extents is not None:
            object.__setattr__(self, "extents",
                               tuple(int(v) for v in self.extents))
        if self.after < 0 or self.times < -1:
            raise ValueError(f"bad fault window: after={self.after} "
                             f"times={self.times}")

    @property
    def site(self) -> str:
        return FAULT_SITES[self.fault]

    def matches(self, site: str, backend: str, extents: tuple[int, ...],
                kind: str, rids: Sequence[int] = ()) -> bool:
        """Coordinate match only — the nth-call window is FaultPlan's."""
        if site != self.site:
            return False
        if self.backend != "*" and backend != self.backend:
            return False
        if self.extents is not None and tuple(extents) != self.extents:
            return False
        if self.kind != "*" and kind != self.kind:
            return False
        if self.rid is not None and self.rid not in rids:
            return False
        return True

    def to_dict(self) -> dict:
        d = {"fault": self.fault}
        for f in fields(self):
            v = getattr(self, f.name)
            if f.name != "fault" and v != f.default:
                d[f.name] = list(v) if f.name == "extents" and v else v
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FaultRule key(s) {sorted(unknown)}; "
                             f"known: {', '.join(sorted(known))}")
        return cls(**d)


class FaultPlan:
    """A seeded, deterministic schedule of injectable failures.

    Thread-safe: the per-rule match counters sit behind one lock, so the
    nth-call windows stay exact under concurrent serve workers.  ``seed``
    rides along for round-trip completeness (and so chaos configs carry
    one identity), but matching itself is deterministic counting.
    """

    def __init__(self, rules: Sequence["FaultRule | dict"] = (),
                 seed: int = 0):
        self.rules: tuple[FaultRule, ...] = tuple(
            r if isinstance(r, FaultRule) else FaultRule.from_dict(dict(r))
            for r in rules)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._matched = [0] * len(self.rules)
        self._fired = [0] * len(self.rules)

    def __bool__(self) -> bool:
        return bool(self.rules)

    def check(self, site: str, backend: str = "*",
              extents: tuple[int, ...] = (), kind: str = "*",
              rids: Sequence[int] = ()) -> list[FaultRule]:
        """Advance every matching rule's counter; return the rules whose
        nth-call window covers this call (i.e. the faults to apply now)."""
        firing: list[FaultRule] = []
        with self._lock:
            for i, rule in enumerate(self.rules):
                if not rule.matches(site, backend, extents, kind, rids):
                    continue
                n = self._matched[i]
                self._matched[i] += 1
                if n < rule.after:
                    continue
                if rule.times >= 0 and n >= rule.after + rule.times:
                    continue
                self._fired[i] += 1
                firing.append(rule)
        return firing

    @property
    def injected(self) -> int:
        with self._lock:
            return sum(self._fired)

    def is_poison(self, extents: tuple[int, ...], kind: str,
                  rid: Optional[int] = None) -> bool:
        """Is a request with these coordinates *unrecoverably* doomed by
        this plan — an always-on (``after=0, times=-1``) error fault that
        matches every backend (so no fallback candidate escapes it), or
        any unbounded error fault pinned to this exact request id?"""
        for rule in self.rules:
            if rule.fault not in ("compile_error", "execute_error",
                                  "nan_output"):
                continue
            if rule.times != -1 or rule.after != 0:
                continue
            if rule.extents is not None and tuple(extents) != rule.extents:
                continue
            if rule.kind != "*" and kind != rule.kind:
                continue
            if rule.rid is not None:
                if rid is not None and rid == rule.rid:
                    return True
                continue
            if rule.backend == "*":
                return True
        return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "injected": sum(self._fired),
                "rules": [{**r.to_dict(), "matched": m, "fired": f}
                          for r, m, f in zip(self.rules, self._matched,
                                             self._fired)],
            }

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "rules": [r.to_dict() for r in self.rules]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls(rules=d.get("rules", ()), seed=d.get("seed", 0))


def faulty_build(build, fault_plan: Optional[FaultPlan], problem):
    """Wrap a planner ``build(candidate)`` callable so build-site rules in
    ``fault_plan`` fire before the real compile — the injection point for
    :func:`repro_torch.core.plan.make_plan`'s fallback walk, kept here so the
    core planner never imports the serve layer."""
    if fault_plan is None:
        return build

    def wrapped(cand):
        for rule in fault_plan.check("build", cand.backend, problem.extents,
                                     problem.kind):
            if rule.fault == "compile_error":
                raise FaultInjected(
                    f"injected compile error: {cand.key()} @ "
                    f"{problem.signature()}")
        return build(cand)

    return wrapped
