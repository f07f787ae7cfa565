"""Serving requests and their completion futures.

A request is one FFT job in flight through the service: the problem
coordinates (extents / kind / precision — the same axes a SuiteSpec sweeps),
the host payload, and the three observability timestamps the latency report
is built from:

    t_enqueue   submit() accepted the request into the bounded queue
    t_dispatch  a worker pulled it into a (possibly coalesced) batch
    t_complete  its result (or error) was published to the future

``latency_ms = t_complete - t_enqueue`` is the number the p50/p95/p99
columns summarize; ``queue_ms = t_dispatch - t_enqueue`` separates queueing
delay from device time.

The future is a plain ``threading.Event`` wrapper (no asyncio: the engine
loop and the submitters are threads), completed exactly once — with a
result, or with a :class:`ServeError` that ``result()`` re-raises.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.client import KINDS, PRECISIONS, Problem


class ServeError(RuntimeError):
    """A request failed inside the service (engine error or timeout).
    The failure is recorded as a clean error result row — the worker loop
    itself never dies with the request.  ``retryable`` marks whether the
    engine may re-enqueue the request (with backoff) instead of failing it;
    engine errors default to retryable, deadline/backpressure failures
    don't (retrying an expired request only wastes a worker's time)."""

    retryable = True


class RequestTimeout(ServeError):
    """The request's deadline passed before its result was produced."""

    retryable = False


class QueueFull(ServeError):
    """Backpressure: the bounded request queue rejected a non-blocking
    submit (or a blocking one timed out waiting for space)."""

    retryable = False


_req_ids = itertools.count()


@dataclass
class FFTRequest:
    """One in-flight FFT job (forward transform of ``payload``)."""

    payload: np.ndarray                 # (*extents) or (b, *extents)
    extents: tuple[int, ...]
    kind: str = "Outplace_Complex"
    precision: str = "float"
    rows: int = 1                       # batch rows this request occupies
    rid: int = field(default_factory=lambda: next(_req_ids))
    deadline: Optional[float] = None    # perf_counter() deadline, if any
    # --- observability timestamps (perf_counter seconds) -------------------
    t_enqueue: float = 0.0
    t_dispatch: float = 0.0
    t_complete: float = 0.0
    # --- completion --------------------------------------------------------
    _event: threading.Event = field(default_factory=threading.Event)
    _result: Optional[np.ndarray] = None
    _error: Optional[ServeError] = None
    coalesced: int = 0                  # batch size this request rode in
    # --- fault tolerance ----------------------------------------------------
    retries_left: int = 0               # re-enqueues the engine may still do
    attempts: int = 0                   # dispatch attempts consumed so far

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown kind {self.kind!r}; known: {KINDS}")
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"unknown precision {self.precision!r}; known: {PRECISIONS}")

    # --- identity ----------------------------------------------------------
    @property
    def plan_key(self) -> tuple:
        """Requests sharing this key run the same plan — the coalescer may
        stack them on the batch axis of one kernel launch."""
        return (self.extents, self.kind, self.precision)

    def problem(self, batch: Optional[int] = None) -> Problem:
        return Problem(self.extents, self.kind, self.precision,
                       batch=batch if batch is not None else self.rows)

    @property
    def signal_bytes(self) -> int:
        return self.problem().signal_bytes

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.perf_counter() if now is None else now) > self.deadline

    # --- future protocol ---------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def ok(self) -> bool:
        return self.done() and self._error is None

    @property
    def error(self) -> Optional[ServeError]:
        return self._error

    @property
    def latency_ms(self) -> float:
        return (self.t_complete - self.t_enqueue) * 1e3

    @property
    def queue_ms(self) -> float:
        return (self.t_dispatch - self.t_enqueue) * 1e3

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until complete; raise the request's error if it failed."""
        if not self._event.wait(timeout):
            raise RequestTimeout(
                f"request {self.rid} not complete after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def _complete(self, result: Optional[np.ndarray] = None,
                  error: Optional[ServeError] = None) -> None:
        """Publish the outcome (exactly once; later calls are ignored so a
        late device result cannot clobber a timeout already reported)."""
        if self._event.is_set():
            return
        self._result = result
        self._error = error
        self.t_complete = time.perf_counter()
        self._event.set()


def make_request(payload: np.ndarray, kind: str = "Outplace_Complex",
                 precision: Optional[str] = None, rank: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 retries: int = 0) -> FFTRequest:
    """Build a request from a host array.

    ``rank`` splits the leading axes into batch rows vs. transform extents
    (default: the whole shape is one transform, rows=1).  ``precision`` is
    inferred from the dtype when omitted.  ``retries`` seeds
    ``retries_left`` (the service overrides it with its configured policy
    at submit time unless the request already carries a budget).
    """
    payload = np.asarray(payload)
    if not (np.issubdtype(payload.dtype, np.floating)
            or np.issubdtype(payload.dtype, np.complexfloating)):
        raise ValueError(f"payload dtype {payload.dtype} is not a float or "
                         f"complex FFT input")
    shape = tuple(int(s) for s in payload.shape)
    if rank is None:
        rank = len(shape)
    if not 1 <= rank <= len(shape):
        raise ValueError(f"rank {rank} out of range for shape {shape}")
    extents = shape[len(shape) - rank:]
    rows = 1
    for s in shape[:len(shape) - rank]:
        rows *= s
    if precision is None:
        precision = ("double" if payload.dtype in (np.float64, np.complex128)
                     else "float")
    deadline = (time.perf_counter() + timeout_ms / 1e3
                if timeout_ms is not None else None)
    return FFTRequest(payload=payload.reshape(rows, *extents),
                      extents=extents, kind=kind, precision=precision,
                      rows=rows, deadline=deadline, retries_left=retries)
