"""Bounded request queue with backpressure (the service's intake).

A plain condition-variable FIFO, sized by ``maxsize``: when the queue is
full, ``put`` either blocks until a worker drains space (the default — the
open-loop replay leans on this so an over-driven service degrades to
queueing delay, not unbounded memory) or raises :class:`QueueFull`
immediately / after a timeout for callers that prefer load shedding.

Beyond FIFO ``get``, the coalescer needs one extra primitive:
``take_matching(key)`` — remove every queued request sharing a plan key, in
arrival order, up to a row budget.  Keeping it here (under the same lock)
means the coalescer never sees a torn view of the queue.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from .request import FFTRequest, QueueFull


class RequestQueue:
    def __init__(self, maxsize: int = 1024):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._q: deque[FFTRequest] = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    # --- producer side -----------------------------------------------------
    def put(self, req: FFTRequest, block: bool = True,
            timeout: Optional[float] = None) -> None:
        """Enqueue; stamps ``t_enqueue`` on success.  Raises
        :class:`QueueFull` when non-blocking (or the timeout expires) and
        the bound is hit — the backpressure signal."""
        with self._not_full:
            if self._closed:
                raise QueueFull("queue is closed")
            if len(self._q) >= self.maxsize:
                if not block:
                    raise QueueFull(
                        f"queue full: {len(self._q)}/{self.maxsize} requests "
                        f"pending (raise ServeConfig.max_queue, or back off "
                        f"the producer)")
                deadline = (time.perf_counter() + timeout
                            if timeout is not None else None)
                while len(self._q) >= self.maxsize and not self._closed:
                    remaining = (deadline - time.perf_counter()
                                 if deadline is not None else None)
                    if remaining is not None and remaining <= 0:
                        raise QueueFull(
                            f"queue still full after waiting {timeout}s: "
                            f"{len(self._q)}/{self.maxsize} requests pending")
                    self._not_full.wait(remaining)
                if self._closed:
                    raise QueueFull("queue is closed")
            req.t_enqueue = time.perf_counter()
            self._q.append(req)
            self._not_empty.notify()

    def put_many(self, reqs: list[FFTRequest], block: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Enqueue a batch of requests under one lock acquisition with one
        consumer wakeup — the producer-side analogue of coalescing (a
        per-request ``put`` pays a lock + notify + GIL handoff each time).
        All-or-nothing: raises :class:`QueueFull` before enqueuing anything
        if the whole batch cannot fit."""
        if not reqs:
            return
        with self._not_full:
            if self._closed:
                raise QueueFull("queue is closed")
            if len(self._q) + len(reqs) > self.maxsize:
                if not block:
                    raise QueueFull(
                        f"queue cannot take {len(reqs)} more requests "
                        f"({len(self._q)}/{self.maxsize} pending)")
                deadline = (time.perf_counter() + timeout
                            if timeout is not None else None)
                while len(self._q) + len(reqs) > self.maxsize \
                        and not self._closed:
                    remaining = (deadline - time.perf_counter()
                                 if deadline is not None else None)
                    if remaining is not None and remaining <= 0:
                        raise QueueFull(
                            f"queue cannot take {len(reqs)} more requests "
                            f"after waiting {timeout}s "
                            f"({len(self._q)}/{self.maxsize} pending)")
                    self._not_full.wait(remaining)
                if self._closed:
                    raise QueueFull("queue is closed")
            now = time.perf_counter()
            for req in reqs:
                req.t_enqueue = now
                self._q.append(req)
            self._not_empty.notify()

    def requeue(self, req: FFTRequest) -> bool:
        """Re-admit a request the engine is retrying.  Deliberately ignores
        ``maxsize`` — a retry blocking behind fresh intake would deadlock
        the backoff timer thread — but respects ``closed`` (returns False;
        the caller fails the request cleanly).  Re-entered at the FRONT:
        the request's original arrival predates everything queued now."""
        with self._lock:
            if self._closed:
                return False
            self._q.appendleft(req)
            self._not_empty.notify()
            return True

    # --- consumer side -----------------------------------------------------
    def get(self, timeout: Optional[float] = None) -> Optional[FFTRequest]:
        """Pop the oldest request; ``None`` on timeout or when the queue is
        closed and drained (the worker's shutdown signal)."""
        with self._not_empty:
            deadline = (time.perf_counter() + timeout
                        if timeout is not None else None)
            while not self._q:
                if self._closed:
                    return None
                remaining = (deadline - time.perf_counter()
                             if deadline is not None else None)
                if remaining is not None and remaining <= 0:
                    return None
                self._not_empty.wait(remaining)
            req = self._q.popleft()
            self._not_full.notify()
            return req

    def take_matching(self, key: tuple, max_rows: int) -> list[FFTRequest]:
        """Remove queued requests whose ``plan_key`` equals ``key``, oldest
        first, stopping before a request that would push the summed batch
        rows past ``max_rows``.  Used by the coalescer to top up a batch."""
        out: list[FFTRequest] = []
        rows = 0
        with self._lock:
            kept: deque[FFTRequest] = deque()
            while self._q:
                req = self._q.popleft()
                if req.plan_key == key and rows + req.rows <= max_rows:
                    out.append(req)
                    rows += req.rows
                else:
                    kept.append(req)
            self._q = kept
            if out:
                self._not_full.notify_all()
        return out

    # --- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Stop accepting new work; blocked getters drain what remains and
        then receive ``None``."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed
