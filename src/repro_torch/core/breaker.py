"""Backend quarantine: a circuit breaker over (backend, problem-class) pairs.

The keys (``problem_class``, ``breaker_key``) are the granularity that
wisdom's demotion records share between the packages.  ``plan.py``
re-exports everything here; the serve engine imports it on its own.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from .client import Problem
from .extents import classify


def problem_class(problem: Problem) -> str:
    """The quarantine granularity: a backend that fails for one oddshape
    rank-2 problem is suspect for every oddshape rank-2 problem, but a
    powerof2 rank-1 success says nothing about either."""
    return f"{classify(problem.extents)}|r{problem.rank}"


def breaker_key(backend: str, problem: Problem) -> str:
    return f"{backend}|{problem_class(problem)}"


class CircuitBreaker:
    """Quarantine for (backend, problem-class) pairs that keep failing.

    Classic three-state breaker, keyed by :func:`breaker_key`:

      closed     pair is healthy; every attempt allowed
      open       ``threshold`` consecutive failures seen — attempts denied
                 until ``cooldown_s`` elapses
      half_open  cooldown elapsed; exactly ONE probe attempt is allowed
                 through.  Success re-closes the breaker, failure re-opens
                 it (and restarts the cooldown).  If the probe never
                 resolves (its thread died), a fresh probe is allowed after
                 another cooldown, so a lost probe can't wedge the pair
                 open forever.

    Thread-safe: all transitions happen under one lock, and the totals
    (``failures``/``successes``) are exact counts of the record calls —
    the invariant the threaded hammer test pins.  ``clock`` is injectable
    for deterministic tests.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1: {threshold}")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}

    def _entry(self, key: str) -> dict:
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = {
                "state": self.CLOSED, "consecutive": 0, "failures": 0,
                "successes": 0, "opens": 0, "opened_at": 0.0,
                "probe_at": None}
        return e

    def allows(self, key: str) -> bool:
        """May the caller *attempt* this pair right now?  Claims the
        half-open probe slot when it grants one — call only when about to
        actually try (use :meth:`available` for side-effect-free checks)."""
        now = self._clock()
        with self._lock:
            e = self._entry(key)
            if e["state"] == self.CLOSED:
                return True
            if e["state"] == self.OPEN:
                if now - e["opened_at"] < self.cooldown_s:
                    return False
                e["state"] = self.HALF_OPEN
                e["probe_at"] = now
                return True       # the cooldown-expiry probe
            # HALF_OPEN: one outstanding probe at a time
            if e["probe_at"] is not None \
                    and now - e["probe_at"] < self.cooldown_s:
                return False
            e["probe_at"] = now   # previous probe was lost; allow another
            return True

    def available(self, key: str) -> bool:
        """Side-effect-free: would an attempt plausibly be allowed?"""
        with self._lock:
            e = self._entries.get(key)
            if e is None or e["state"] != self.OPEN:
                return True
            return self._clock() - e["opened_at"] >= self.cooldown_s

    def record_failure(self, key: str) -> str:
        """Count a failure; returns the pair's new state (``'open'`` means
        this failure tripped — or re-tripped — the quarantine)."""
        with self._lock:
            e = self._entry(key)
            e["failures"] += 1
            e["consecutive"] += 1
            if e["state"] == self.HALF_OPEN \
                    or e["consecutive"] >= self.threshold:
                if e["state"] != self.OPEN:
                    e["opens"] += 1
                e["state"] = self.OPEN
                e["opened_at"] = self._clock()
                e["probe_at"] = None
            return e["state"]

    def record_success(self, key: str) -> str:
        with self._lock:
            e = self._entry(key)
            e["successes"] += 1
            e["consecutive"] = 0
            e["state"] = self.CLOSED
            e["probe_at"] = None
            return e["state"]

    def state(self, key: str) -> str:
        with self._lock:
            e = self._entries.get(key)
            return e["state"] if e else self.CLOSED

    def snapshot(self) -> dict:
        with self._lock:
            return {k: {"state": e["state"], "failures": e["failures"],
                        "successes": e["successes"], "opens": e["opens"]}
                    for k, e in self._entries.items()}
