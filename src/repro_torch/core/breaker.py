"""Backend quarantine keys: the (backend, problem-class) granularity that
wisdom's demotion records use.

The reference package's ``breaker.py`` also holds the circuit breaker
itself (``CircuitBreaker``) and the fault-tolerant planning around it;
they come with the serving slice.  These two keys are the part a wisdom
file shares between the packages.
"""

from __future__ import annotations

from .client import Problem
from .extents import classify


def problem_class(problem: Problem) -> str:
    """The quarantine granularity: a backend that fails for one oddshape
    rank-2 problem is suspect for every oddshape rank-2 problem."""
    return f"{classify(problem.extents)}|r{problem.rank}"


def breaker_key(backend: str, problem: Problem) -> str:
    return f"{backend}|{problem_class(problem)}"
