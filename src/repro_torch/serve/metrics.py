"""Per-request observability: latency percentiles, throughput, counters.

One :class:`ServiceMetrics` instance per service, fed under a lock from the
worker threads.  ``snapshot()`` renders the serving report:

* latency (enqueue→complete) and queue-wait (enqueue→dispatch) p50/p95/p99
  — shared quantile math with the result tables
  (:func:`repro_torch.core.results.percentile_summary`);
* sustained GiB/s (and requests/s) from the service's construction to the
  last completion, as in the reference (a prewarm's builds fall inside
  that window), at the algorithmic minimum of one HBM read + one write
  per request signal (the same convention ``benchmarks/bench_grid.py`` uses,
  so serving numbers compare against the offline trajectory);
* coalescing counters: batches launched vs. requests served — a coalesce
  rate of ``1 - batches/requests`` — plus padded rows (bucket slack);
* failure counters, each its own column: engine errors, deadline timeouts,
  backpressure sheds, retries (and how many of them ultimately succeeded);
* robustness counters: plan demotions (fallback-chain hops past a failed
  backend), batch bisections, injected faults, watchdog worker restarts,
  wedged workers at shutdown;
* when a plan cache / circuit breaker is attached, its hit/miss totals and
  the per-(backend, problem-class) quarantine states.
"""

from __future__ import annotations

import statistics
import threading
import time

from ..core.results import percentile_summary

#: Latency samples kept for the percentile estimate; beyond this the
#: recorder keeps a uniform random reservoir so a week-long service does
#: not grow memory with traffic.
MAX_SAMPLES = 100_000


class ServiceMetrics:
    def __init__(self, max_samples: int = MAX_SAMPLES):
        self._lock = threading.Lock()
        self._max_samples = max_samples
        self._latencies_ms: list[float] = []
        self._queue_ms: list[float] = []
        self._seen = 0                    # total samples offered
        self._rng_state = 0x9E3779B97F4A7C15
        self.submitted = 0
        self.completed = 0
        self.errors = 0                   # engine errors (non-timeout)
        self.timeouts = 0
        self.sheds = 0                    # QueueFull rejections at submit
        self.retries = 0                  # re-enqueues after a failure
        self.retry_successes = 0          # completions that needed >=1 retry
        self.demotions = 0                # fallback hops past a bad backend
        self.bisections = 0               # failed-batch splits
        self.faults_injected = 0          # chaos: FaultPlan rules fired
        self.worker_restarts = 0          # watchdog thread replacements
        self.wedged = 0                   # workers alive past stop() joins
        self.batches = 0
        self.batched_requests = 0         # requests served in size>1 batches
        self.padded_rows = 0              # bucket slack rows computed
        self.bytes_moved = 0              # 2 * signal bytes per completion
        self.t_start = time.perf_counter()
        self.t_last = self.t_start

    # --- tiny deterministic splitmix for reservoir sampling ----------------
    def _rand(self, n: int) -> int:
        self._rng_state = (self._rng_state + 0x9E3779B97F4A7C15) % (1 << 64)
        z = self._rng_state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % (1 << 64)
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % (1 << 64)
        return (z ^ (z >> 31)) % n

    def _keep(self, store: list[float], v: float) -> None:
        if len(store) < self._max_samples:
            store.append(v)
        else:                             # reservoir: uniform over history
            i = self._rand(self._seen)
            if i < self._max_samples:
                store[i] = v

    # --- feed --------------------------------------------------------------
    def on_submit(self, n: int = 1) -> None:
        with self._lock:
            self.submitted += n

    def on_batch(self, n_requests: int, rows: int, padded_rows: int) -> None:
        with self._lock:
            self.batches += 1
            if n_requests > 1:
                self.batched_requests += n_requests
            self.padded_rows += padded_rows

    def on_complete(self, latency_ms: float, queue_ms: float,
                    nbytes: int, retried: bool = False) -> None:
        with self._lock:
            self.completed += 1
            self._seen += 1
            self._keep(self._latencies_ms, latency_ms)
            self._keep(self._queue_ms, queue_ms)
            self.bytes_moved += 2 * nbytes   # one read + one write
            if retried:
                self.retry_successes += 1
            self.t_last = time.perf_counter()

    def on_error(self, timeout: bool = False) -> None:
        with self._lock:
            if timeout:
                self.timeouts += 1
            else:
                self.errors += 1

    def on_shed(self, n: int = 1) -> None:
        with self._lock:
            self.sheds += n

    def on_retry(self) -> None:
        with self._lock:
            self.retries += 1

    def on_demotion(self, n: int = 1) -> None:
        with self._lock:
            self.demotions += n

    def on_bisect(self) -> None:
        with self._lock:
            self.bisections += 1

    def on_fault(self, n: int = 1) -> None:
        with self._lock:
            self.faults_injected += n

    def on_worker_restart(self) -> None:
        with self._lock:
            self.worker_restarts += 1

    def on_wedge(self, n: int = 1) -> None:
        with self._lock:
            self.wedged += n

    # --- report ------------------------------------------------------------
    def snapshot(self, plan_stats=None, quarantine=None) -> dict:
        """The serving report, as plain data (JSON-ready)."""
        with self._lock:
            lat = list(self._latencies_ms)
            qms = list(self._queue_ms)
            elapsed = max(self.t_last - self.t_start, 1e-9)
            out = {
                "requests": self.submitted,
                "completed": self.completed,
                "errors": self.errors,
                "timeouts": self.timeouts,
                "sheds": self.sheds,
                "retries": self.retries,
                "retry_successes": self.retry_successes,
                "demotions": self.demotions,
                "bisections": self.bisections,
                "faults_injected": self.faults_injected,
                "worker_restarts": self.worker_restarts,
                "wedged": self.wedged,
                "batches": self.batches,
                "batched_requests": self.batched_requests,
                "padded_rows": self.padded_rows,
                "coalesce_rate": (1.0 - self.batches / self.completed
                                  if self.completed else 0.0),
                "elapsed_s": elapsed,
                "rps": self.completed / elapsed,
                "gib_per_s": self.bytes_moved / elapsed / 2**30,
            }
        if lat:
            out["latency_ms"] = {"mean": statistics.fmean(lat),
                                 **percentile_summary(lat)}
            out["queue_ms"] = {"mean": statistics.fmean(qms),
                               **percentile_summary(qms)}
        if plan_stats is not None:
            out["plan_cache"] = plan_stats.as_dict()
        if quarantine is not None:
            out["quarantine"] = quarantine
        return out
