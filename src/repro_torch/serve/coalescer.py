"""Request coalescing: same-plan requests become one batched kernel launch.

The fused kernels are batch-tiled already (``tile_b`` is the knob), so n
requests for the same (extents, kind, precision) stack on the batch axis of
ONE built transform and slice their results back out — n dispatches
collapse into one, which is where the serving throughput win comes from.

Policy: pull the oldest request, then top the batch up with every queued
request sharing its plan key; if the batch still has row budget and the
coalesce window is open, linger — wait up to ``window_ms`` from the *first*
request's dequeue for stragglers to arrive.  A zero window (or
``max_rows=1``) degrades to strict one-request-per-launch FIFO, which is
the serial baseline the benchmark compares against.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from .queue import RequestQueue
from .request import FFTRequest


@dataclass
class Batch:
    """One coalesced kernel launch: same-plan requests, summed batch rows."""

    key: tuple                           # shared plan key
    requests: list[FFTRequest] = field(default_factory=list)

    @property
    def rows(self) -> int:
        return sum(r.rows for r in self.requests)

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    @property
    def extents(self) -> tuple[int, ...]:
        return self.key[0]

    @property
    def kind(self) -> str:
        return self.key[1]

    @property
    def precision(self) -> str:
        return self.key[2]


class Coalescer:
    """Builds batches from a :class:`RequestQueue`.

    ``next_batch`` polls once (up to ``poll_ms``) and returns ``None`` when
    no request arrived — the caller decides whether that means "retire
    in-flight work" or "queue closed, exit" (see the worker loop in
    :mod:`repro_torch.serve.engine`).
    """

    def __init__(self, queue: RequestQueue, window_ms: float = 2.0,
                 max_rows: int = 32):
        if max_rows < 1:
            raise ValueError(f"max_rows must be >= 1, got {max_rows}")
        self.queue = queue
        self.window_ms = max(0.0, float(window_ms))
        self.max_rows = int(max_rows)

    def _top_up(self, batch: Batch) -> None:
        room = self.max_rows - batch.rows
        if room > 0:
            batch.requests.extend(
                self.queue.take_matching(batch.key, room))

    def next_batch(self, poll_ms: float = 50.0) -> Optional[Batch]:
        first = self.queue.get(timeout=poll_ms / 1e3)
        if first is None:
            return None
        batch = Batch(key=first.plan_key, requests=[first])
        self._top_up(batch)
        if self.window_ms > 0 and batch.rows < self.max_rows:
            # linger: give stragglers the rest of the window to coalesce.
            # Sleep in short slices so a filled batch leaves early.
            deadline = time.perf_counter() + self.window_ms / 1e3
            while batch.rows < self.max_rows:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                time.sleep(min(remaining, 0.0005))
                self._top_up(batch)
        return batch
