"""The FFT service engine on torch: a long-lived worker loop over a Session.

Architecture (the reference engine's, with CUDA streams for its async
dispatch):

    submit() ──▶ RequestQueue (bounded: backpressure) ──▶ Coalescer
                                                            │ batches
                                                            ▼
                  ┌──────────────── worker loop ────────────────────┐
                  │ stage rows into a pinned host slab (pow2 bucket)│
                  │ on the worker's stream: copy in, transform,     │
                  │ copy out, record an event                       │
                  │ retire the oldest batch: wait on its event,     │
                  │ copy each request's rows out                    │
                  └─────────────────────────────────────────────────┘

Perf machinery:

* **Coalescing**: same-plan requests stack on the batch axis of one built
  transform (see :mod:`repro_torch.serve.coalescer`).
* **Batch buckets**: coalesced row counts are rounded up to powers of two,
  so at most log2(max_batch) transforms are built per plan; slack rows are
  staged as zeros and sliced away (``padded_rows`` in the metrics).
* **Streams**: each worker owns one ``torch.cuda.Stream``, and a batch's
  host-to-device copy, transform and device-to-host copy are issued on it
  without blocking.  The kernels launch on ``torch.cuda.current_stream``,
  as ``torch.fft`` does, so the stream context is all they need; up to
  ``inflight`` batches per worker are on the card while the worker stages
  the next one.  On the CPU the same code runs with no stream or event.
* **Pinned slabs**: each worker stages through its own slots, each a
  pinned input slab and a pinned output slab grown to the largest batch
  seen, with a typed view per batch.  ``prewarm`` grows them to the
  largest bucket it builds, so the pinned allocation (slow and large:
  hundreds of ms for a few hundred MiB) is paid outside the measured
  window.
* **Finiteness probe on the device**: one reduction per batch on the
  worker's stream gives a flag per row, copied out beside the rows, so
  retire reads a few bytes instead of scanning the output on the host.

Fault tolerance (the reference's): fallback chains with a circuit breaker
per (backend, problem class), retries with jittered backoff, bisection of
failed batches, a watchdog that fails a dead worker's requests and
restarts it, and seeded fault injection (``ServeConfig.faults``).  On a
CUDA device only an injected fault (:class:`FaultInjected`) or a
wisdom/breaker quarantine moves the walk to the next candidate: a real
exception from building or launching a hand-written kernel is not demoted
past.  It is kept in ``worker_errors`` and fails its requests through the
retry and bisect path, with a message that names the kernel.  On the CPU,
where the kernels run their plain versions, every exception demotes as in
the reference.

Concurrency: the PlanCache is shared with the owning Session; its lookups
are single-flight and lock-guarded, so several workers (or a worker and a
foreground ``Session.run``) race safely on cold plans.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, fields
from typing import Any, Optional

import numpy as np
import torch

from ..core.client import Problem
from ..core.clients.torch_fft import _TORCH_DTYPES, _forward_fn
from ..core.extents import classify, format_extents, next_pow2
from ..core.plan import (Candidate, CircuitBreaker, PlanCache, PlanRigor,
                         breaker_key, fallback_chain, is_kernel_fault,
                         make_plan, walk_fallback_chain)
from ..core.results import Row
from .coalescer import Batch, Coalescer
from .faults import FaultInjected, FaultPlan, WorkerKilled
from .metrics import ServiceMetrics
from .queue import RequestQueue
from .request import (FFTRequest, QueueFull, RequestTimeout, ServeError,
                      make_request)

#: The client title the service's request rows carry.
LIBRARY = "TorchServeFFT"


class WorkerWedged(ServeError):
    """``stop()`` gave up on one or more workers that would not join within
    the configured deadline.  ``snapshot`` carries the final report (with
    ``wedged_workers`` naming the stuck threads)."""

    retryable = False

    def __init__(self, msg: str, snapshot: Optional[dict] = None):
        super().__init__(msg)
        self.snapshot = snapshot or {}


class KernelFault(ServeError):
    """A hand-written kernel failed to build or launch on the card.  It is
    not demoted past: the request is retried on the same plan and fails
    with this message, which names the kernel."""

    def __init__(self, cand: Candidate, problem: Problem, err: BaseException):
        super().__init__(
            f"engine error: kernel {cand.backend} ({cand.key()}) failed for "
            f"{problem.signature()}: {type(err).__name__}: {err}")


@dataclass(frozen=True)
class ServeConfig:
    """Service tuning knobs (plain data: round-trips via to/from_dict like
    every other spec in the suite)."""

    max_queue: int = 1024            # bounded intake: the backpressure knob
    coalesce_window_ms: float = 2.0  # linger for stragglers; 0 = serial FIFO
    max_batch: int = 32              # row budget per coalesced launch
    workers: int = 1                 # consumer threads, one stream each
    inflight: int = 2                # batches in flight per worker
    rigor: str = "estimate"          # planner rigor for request-time plans
    backend: Optional[str] = None    # pin one backend (bench per-library)
    costmodel: Optional[str] = None  # fitted coefficient-table path: plans
    #                                  and fallback chains rank under it
    timeout_ms: Optional[float] = None   # default per-request deadline
    bucket_batches: bool = True      # pow2-pad coalesced rows
    record_requests: bool = True     # keep per-request rows for ResultSet
    # --- fault tolerance ----------------------------------------------------
    fallback: bool = True            # demote past failed plan candidates
    max_retries: int = 2             # re-enqueues per request on failure
    backoff_base_ms: float = 0.5     # first-retry backoff (doubles per try)
    backoff_max_ms: float = 50.0     # backoff cap
    bisect_batches: bool = True      # split failed coalesced batches in two
    probe_output: bool = True        # reject non-finite outputs at retire
    breaker_threshold: int = 3       # consecutive failures to quarantine
    breaker_cooldown_s: float = 5.0  # quarantine time before half-open probe
    watchdog_interval_s: float = 0.25    # worker liveness poll; 0 = off
    join_timeout_s: float = 60.0     # stop(): per-worker join deadline
    drain_timeout_s: float = 60.0    # stop(drain=True): total drain budget
    faults: tuple = ()               # FaultRule dicts (chaos injection)

    def __post_init__(self):
        if self.max_queue < 1 or self.max_batch < 1 or self.workers < 1 \
                or self.inflight < 1:
            raise ValueError(f"bad ServeConfig bounds: {self}")
        if self.rigor not in {r.value for r in PlanRigor}:
            raise ValueError(f"unknown rigor {self.rigor!r}")
        if self.max_retries < 0 or self.breaker_threshold < 1:
            raise ValueError(f"bad ServeConfig fault-tolerance bounds: {self}")
        # fault rules as plain dicts, each validated through FaultRule
        from .faults import FaultRule
        rules = tuple(
            (r if isinstance(r, FaultRule)
             else FaultRule.from_dict(dict(r))).to_dict()
            for r in self.faults)
        object.__setattr__(self, "faults", rules)

    def to_dict(self) -> dict:
        d = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if f.name == "faults":
                if v:
                    d[f.name] = [dict(r) for r in v]
            elif v is not None:
                d[f.name] = v
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ServeConfig":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ServeConfig key(s) {sorted(unknown)}; "
                             f"known: {', '.join(sorted(known))}")
        return cls(**d)


def _slot_bytes(problem: Problem) -> tuple[int, int]:
    """Bytes of a batch's input slab and output slab: a real kind's output
    is the complex half spectrum of the last axis, and the output slab
    also holds the probe's flag per batch row."""
    if problem.complex_input:
        out = problem.signal_bytes
    else:
        rows = problem.n_elems // problem.extents[-1]
        half = rows * (problem.extents[-1] // 2 + 1)
        out = half * 2 * problem.real_dtype.itemsize
    return problem.signal_bytes, out + problem.batch


class _Slot:
    """One staging slot of a worker: a host slab for a batch's input rows,
    one for its output, and the event of the last batch that used them.
    A slot is busy from dispatch until its batch is retired."""

    __slots__ = ("inp", "out", "event", "busy")

    def __init__(self):
        self.inp = self.out = None
        self.event: Optional[torch.cuda.Event] = None
        self.busy = False


class _WorkerBuffers:
    """A worker's stream and staging slots (``inflight + 1`` of them, more
    if a bisection needs them).

    Staging reuse: a ``non_blocking`` copy from pinned memory has not
    copied when it returns (``jax.device_put`` had), so no slot is shared
    between workers, a slot is not refilled while its batch is in flight,
    and a refill first waits for the event of the copies that last used
    it.  A restarted worker gets new buffers, so a dead worker's pending
    copies cannot write into them."""

    def __init__(self, device: torch.device, depth: int):
        self.on_card = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.on_card else None
        self.slots = [_Slot() for _ in range(depth)]
        self.in_bytes = self.out_bytes = 0
        self.lock = threading.Lock()

    def _slab(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8,
                           pin_memory=self.on_card)

    def _grow(self, slot: _Slot) -> None:
        if slot.event is not None:
            slot.event.synchronize()
        if slot.inp is None or slot.inp.numel() < self.in_bytes:
            slot.inp = self._slab(self.in_bytes)
        if slot.out is None or slot.out.numel() < self.out_bytes:
            slot.out = self._slab(self.out_bytes)

    def grow(self, in_bytes: int, out_bytes: int) -> None:
        """Grow every idle slot's slabs to at least these sizes now (a
        busy slot grows when it is next taken)."""
        with self.lock:
            self.in_bytes = max(self.in_bytes, in_bytes)
            self.out_bytes = max(self.out_bytes, out_bytes)
            for slot in self.slots:
                if not slot.busy:
                    self._grow(slot)

    def acquire(self, in_bytes: int, out_bytes: int) -> _Slot:
        """A free slot whose slabs hold the batch, its last copies done."""
        with self.lock:
            self.in_bytes = max(self.in_bytes, in_bytes)
            self.out_bytes = max(self.out_bytes, out_bytes)
            slot = next((s for s in self.slots if not s.busy), None)
            if slot is None:
                slot = _Slot()
                self.slots.append(slot)
            self._grow(slot)
            slot.busy = True
            return slot

    def stream_ctx(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else nullcontext())


def _view(slab: torch.Tensor, dtype: torch.dtype, shape,
          offset: int = 0) -> torch.Tensor:
    """A typed view of a slab's bytes from ``offset`` on."""
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    return slab[offset:offset + n].view(dtype).view(tuple(shape))


class _Inflight:
    """One dispatched batch awaiting retirement: its output rows and the
    probe's row flags (views of its slot's output slab; ``finite`` is None
    with the probe off) and the event after their copy out."""

    __slots__ = ("batch", "out", "finite", "row_spans", "t_dispatch", "cand",
                 "event", "slot")

    def __init__(self, batch: Batch, out: torch.Tensor,
                 finite: Optional[torch.Tensor],
                 row_spans: list[tuple[int, int]], t_dispatch: float,
                 cand: Optional[Candidate], event, slot: _Slot):
        self.batch = batch
        self.out = out
        self.finite = finite
        self.row_spans = row_spans
        self.t_dispatch = t_dispatch
        self.cand = cand
        self.event = event
        self.slot = slot


class FFTService:
    """Long-lived FFT serving loop on top of a Session.

    Use as a context manager (``with FFTService(session) as svc``) or call
    :meth:`start` / :meth:`stop` explicitly.  ``submit`` returns the request
    itself, which doubles as the completion future.  With no session it
    serves on ``cuda:0`` (``Session()``), and raises where there is no
    card.
    """

    def __init__(self, session=None, config: ServeConfig = ServeConfig(),
                 wisdom=None, fault_plan: Optional[FaultPlan] = None):
        from ..core.suite import Session

        self.session = session if session is not None else Session()
        self.device = self.session.context.device
        self.session.device_kind      # discovers the device: raises if absent
        self.config = config
        self.wisdom = wisdom if wisdom is not None \
            else getattr(self.session, "_wisdom", None)
        self.fault_plan = fault_plan if fault_plan is not None \
            else (FaultPlan(config.faults) if config.faults else None)
        self.breaker = CircuitBreaker(threshold=config.breaker_threshold,
                                      cooldown_s=config.breaker_cooldown_s)
        self.queue = RequestQueue(config.max_queue)
        self.metrics = ServiceMetrics()
        self._coalescer = Coalescer(self.queue,
                                    window_ms=config.coalesce_window_ms,
                                    max_rows=config.max_batch)
        self._threads: list[threading.Thread] = []
        self._threads_lock = threading.Lock()
        self._buffers: dict[str, _WorkerBuffers] = {}
        self._slab_bytes = (0, 0)     # largest (in, out) bucket prewarmed
        self._chains: dict[str, list[Candidate]] = {}
        self._served: dict[str, str] = {}
        self._chains_lock = threading.Lock()
        self._cost_model = None
        self._rows: list[Row] = []
        self._rows_lock = threading.Lock()
        self._started = False
        self._worker_errors: list[BaseException] = []
        # watchdog state: per-worker in-flight registries so a dead worker's
        # requests can be failed cleanly instead of hanging their futures
        self._pending_by_worker: dict[str, deque] = {}
        self._orphans: dict[str, list[FFTRequest]] = {}
        self._worker_state_lock = threading.Lock()
        self._worker_seq = 0
        self._watchdog: Optional[threading.Thread] = None
        self._stop_event = threading.Event()

    def _on_card(self) -> bool:
        """Whether the transforms run on a CUDA device (hand-written
        kernels) rather than their plain versions on the CPU."""
        return self.device.type == "cuda"

    # --- lifecycle ---------------------------------------------------------
    def _spawn(self, name: str) -> threading.Thread:
        """A worker thread with its own stream and staging buffers (not
        started); call with ``_threads_lock`` held."""
        bufs = _WorkerBuffers(self.device, self.config.inflight + 1)
        bufs.grow(*self._slab_bytes)
        self._buffers[name] = bufs
        t = threading.Thread(target=self._worker_loop, name=name, daemon=True)
        self._threads.append(t)
        return t

    def start(self) -> "FFTService":
        if self._started:
            return self
        self._started = True
        self._stop_event.clear()
        with self._threads_lock:
            started = [self._spawn(f"fft-serve-{i}")
                       for i in range(self.config.workers)]
        for t in started:
            t.start()
        if self.config.watchdog_interval_s > 0:
            self._watchdog = threading.Thread(target=self._watchdog_loop,
                                              name="fft-serve-watchdog",
                                              daemon=True)
            self._watchdog.start()
        return self

    def stop(self, drain: bool = True) -> dict:
        """Shut down: close the intake, let workers drain what is queued
        (``drain=False`` fails queued requests instead), join, and return
        the final metrics snapshot (``worker_errors`` / ``wedged_workers``
        included).

        Bounded: each worker gets at most ``join_timeout_s`` and the drain
        as a whole at most ``drain_timeout_s``; then still-queued requests
        are failed, and a worker that still will not join is reported
        through :class:`WorkerWedged`.  The joined workers' staging slabs
        are released."""
        self._stop_event.set()           # watchdog: no more restarts
        if self._watchdog is not None:
            self._watchdog.join(timeout=5.0)
            self._watchdog = None
        if not drain:
            self._fail_queued(lambda: ServeError("service stopped"))
        self.queue.close()
        deadline = time.perf_counter() + self.config.drain_timeout_s
        with self._threads_lock:
            threads = list(self._threads)
        for t in threads:
            budget = min(self.config.join_timeout_s,
                         deadline - time.perf_counter())
            t.join(timeout=max(0.0, budget))
        still = [t for t in threads if t.is_alive()]
        if still and drain:
            # drain budget blown: shed the remaining queue so the workers
            # can reach their shutdown signal, then give one last grace join
            self._fail_queued(lambda: ServeError(
                f"service stopping: drain deadline "
                f"({self.config.drain_timeout_s:.0f}s) exceeded"))
            for t in still:
                t.join(timeout=1.0)
            still = [t for t in still if t.is_alive()]
        wedged = [t.name for t in still]
        if wedged:
            self.metrics.on_wedge(len(wedged))
        with self._threads_lock:
            self._threads.clear()
            for t in threads:      # a wedged worker keeps its buffers
                if not t.is_alive():
                    self._buffers.pop(t.name, None)
        self._started = False
        snap = self.report()
        snap["wedged_workers"] = wedged
        if wedged:
            raise WorkerWedged(
                f"{len(wedged)} worker(s) failed to join within "
                f"join_timeout_s={self.config.join_timeout_s:.0f}: "
                f"{', '.join(wedged)}", snapshot=snap)
        return snap

    def _fail_queued(self, error) -> None:
        while True:
            req = self.queue.get(timeout=0)
            if req is None:
                return
            self._fail(req, error())

    def __enter__(self) -> "FFTService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- intake ------------------------------------------------------------
    def _requests(self, payloads, kind, precision, rank,
                  timeout_ms) -> list[FFTRequest]:
        if not self._started:
            raise ServeError("service not started (use 'with FFTService(...)'"
                             " or call start())")
        if timeout_ms is None:
            timeout_ms = self.config.timeout_ms
        reqs = [make_request(p, kind=kind, precision=precision, rank=rank,
                             timeout_ms=timeout_ms,
                             retries=self.config.max_retries)
                for p in payloads]
        for req in reqs:
            if req.rows > self.config.max_batch:
                raise ServeError(
                    f"request rows {req.rows} exceed max_batch "
                    f"{self.config.max_batch}")
        self.metrics.on_submit(len(reqs))
        return reqs

    def submit(self, payload: np.ndarray, kind: str = "Outplace_Complex",
               precision: Optional[str] = None, rank: Optional[int] = None,
               timeout_ms: Optional[float] = None, block: bool = True,
               block_timeout: Optional[float] = None) -> FFTRequest:
        """Enqueue one forward-FFT job; returns its future.

        ``block=False`` sheds load instead of waiting on a full queue
        (raises :class:`QueueFull`).  ``timeout_ms`` overrides the service
        default deadline for this request.
        """
        req, = self._requests([payload], kind, precision, rank, timeout_ms)
        try:
            self.queue.put(req, block=block, timeout=block_timeout)
        except QueueFull:
            self.metrics.on_shed()
            raise
        return req

    def submit_many(self, payloads, kind: str = "Outplace_Complex",
                    precision: Optional[str] = None,
                    rank: Optional[int] = None,
                    timeout_ms: Optional[float] = None, block: bool = True,
                    block_timeout: Optional[float] = None
                    ) -> list[FFTRequest]:
        """Enqueue a burst of jobs in one shot (one queue lock and one
        worker wakeup), all-or-nothing on a full queue.  All payloads share
        the kind / precision / deadline; returns the futures in order."""
        reqs = self._requests(payloads, kind, precision, rank, timeout_ms)
        try:
            self.queue.put_many(reqs, block=block, timeout=block_timeout)
        except QueueFull:
            self.metrics.on_shed(len(reqs))
            raise
        return reqs

    def prewarm(self, extents, kind: str = "Outplace_Complex",
                precision: str = "float") -> int:
        """Build the transforms this plan's traffic can hit (every pow2
        batch bucket up to ``max_batch``), run each once on zeros on every
        worker's stream, and grow every worker's staging slabs to the
        largest, before opening the doors, so steady-state percentiles
        measure serving, not builds, first launches, device allocations on
        a worker's stream or pinned allocations.  On the card a first
        launch builds the kernel library (``nvcc``) if no earlier call
        did, loads the kernel and makes cuFFT's plan for the bucket.
        Returns the number of bucket transforms now warm."""
        batch = Batch(key=(tuple(int(v) for v in extents), kind, precision))
        with self._threads_lock:
            bufs = list(self._buffers.values())
        n, bucket = 0, 1
        while bucket <= self.config.max_batch:
            _, transform = self._executable(batch, bucket)
            problem = Problem(batch.extents, kind, precision, batch=bucket)
            for ctx in [b.stream_ctx() for b in bufs] or [nullcontext()]:
                with ctx:
                    y = transform(torch.zeros(
                        (bucket, *batch.extents),
                        dtype=_TORCH_DTYPES[problem.input_dtype],
                        device=self.device))
                    if self.config.probe_output:
                        torch.isfinite(y).flatten(1).all(1)
                    del y
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            n += 1
            last = bucket
            if not self.config.bucket_batches:
                break   # unbucketed rows are unbounded; warm bucket 1 only
            bucket *= 2
        need = _slot_bytes(Problem(batch.extents, kind, precision,
                                   batch=last))
        with self._threads_lock:
            self._slab_bytes = tuple(max(a, b) for a, b in
                                     zip(self._slab_bytes, need))
        for b in bufs:
            b.grow(*need)
        return n

    # --- worker loop -------------------------------------------------------
    def _worker_loop(self) -> None:
        name = threading.current_thread().name
        pending: deque[_Inflight] = deque()
        with self._worker_state_lock:
            self._pending_by_worker[name] = pending
        batch: Optional[Batch] = None
        try:
            while True:
                batch = None
                # With work in flight, poll without blocking so an idle
                # queue retires batches instead of stalling them behind
                # the inflight threshold.
                batch = self._coalescer.next_batch(
                    poll_ms=0.0 if pending else 50.0)
                if batch is None:
                    if pending:
                        self._retire(pending.popleft())
                        continue
                    if self.queue.closed:
                        break
                    continue
                inflight = self._dispatch(batch)
                batch = None
                if inflight is not None:
                    pending.append(inflight)
                while len(pending) >= self.config.inflight:
                    self._retire(pending.popleft())
        except WorkerKilled as e:
            # dirty death: leave the current batch and the pending registry
            # (its batches may still be on the stream) for the watchdog
            with self._worker_state_lock:
                self._orphans[name] = (list(batch.requests)
                                       if batch is not None else [])
            self._worker_errors.append(e)
            return
        except BaseException as e:      # defensive: never die silently
            self._worker_errors.append(e)
        while pending:
            self._retire(pending.popleft())
        with self._worker_state_lock:
            self._pending_by_worker.pop(name, None)

    # --- watchdog ----------------------------------------------------------
    def _watchdog_loop(self) -> None:
        """Supervise the workers: a thread that died while the service is
        live gets its in-flight requests failed cleanly and is replaced."""
        while not self._stop_event.wait(self.config.watchdog_interval_s):
            with self._threads_lock:
                threads = list(self._threads)
            for t in threads:
                if t.is_alive():
                    continue
                if self.queue.closed or self._stop_event.is_set():
                    continue    # clean shutdown exits are not deaths
                self._restart_worker(t)

    def _restart_worker(self, dead: threading.Thread) -> None:
        """Fail the dead worker's batches (one may still be on its stream)
        and start a replacement with a new stream and new buffers; the
        dead worker's buffers are dropped, never handed on."""
        with self._worker_state_lock:
            orphans = self._orphans.pop(dead.name, [])
            pending = self._pending_by_worker.pop(dead.name, None)
        if pending:
            orphans = orphans + [req for inf in pending
                                 for req in inf.batch.requests]
        for req in orphans:
            if not req.done():
                self._fail(req, ServeError(
                    f"worker {dead.name} died with request {req.rid} in "
                    f"flight; failed by watchdog"))
        with self._threads_lock:
            if dead in self._threads:
                self._threads.remove(dead)
            self._buffers.pop(dead.name, None)
            self._worker_seq += 1
            nt = self._spawn(f"fft-serve-r{self._worker_seq}")
        self.metrics.on_worker_restart()
        nt.start()

    # --- fault injection ---------------------------------------------------
    def _apply_faults(self, site: str, backend: str, batch: Batch) -> list:
        """Fire any matching FaultPlan rules at ``site``.  Sleeps are
        applied here; ``kill_worker`` raises :class:`WorkerKilled` (a
        BaseException: it escapes the engine's batch error handling);
        ``compile_error`` raises inline (the build site calls this from
        inside the builder).  Execute-site rules are returned for the
        caller to apply."""
        if self.fault_plan is None:
            return []
        rules = self.fault_plan.check(
            site, backend=backend, extents=batch.extents, kind=batch.kind,
            rids=[r.rid for r in batch.requests])
        if rules:
            self.metrics.on_fault(len(rules))
        for rule in rules:
            if rule.fault in ("transfer_stall", "latency_spike"):
                self._stall(rule.stall_ms / 1e3)
            elif rule.fault == "kill_worker":
                raise WorkerKilled(
                    f"injected worker kill at {site} "
                    f"({format_extents(batch.extents)})")
            elif rule.fault == "compile_error":
                raise FaultInjected(
                    f"injected compile error: {backend} @ "
                    f"{format_extents(batch.extents)}")
        return rules

    def _stall(self, seconds: float) -> None:
        """An injected stall: the worker holds its batch this long."""
        time.sleep(seconds)

    def _is_kernel_fault(self, err: BaseException) -> bool:
        """A real failure of a hand-written kernel on the card
        (:func:`is_kernel_fault`), the service's own errors aside."""
        return not isinstance(err, ServeError) \
            and is_kernel_fault(err, self._on_card())

    # --- dispatch / retire -------------------------------------------------
    def _dispatch(self, batch: Batch) -> Optional[_Inflight]:
        now = time.perf_counter()
        live: list[FFTRequest] = []
        for req in batch.requests:
            req.t_dispatch = now
            req.coalesced = batch.n_requests
            if req.expired(now):
                limit = ((req.deadline - req.t_enqueue) * 1e3
                         if req.deadline is not None else float("nan"))
                self._fail(req, RequestTimeout(
                    f"request {req.rid} expired in queue: waited "
                    f"{req.queue_ms:.1f} ms against a {limit:.0f} ms "
                    f"deadline (queue depth {len(self.queue)}/"
                    f"{self.queue.maxsize})"), timeout=True)
            else:
                live.append(req)
        if not live:
            return None
        batch.requests = live
        rows = batch.rows
        bucket = next_pow2(rows) if self.config.bucket_batches else rows
        cand: Optional[Candidate] = None
        slot: Optional[_Slot] = None
        try:
            cand, transform = self._executable(batch, bucket)
            self._apply_faults("dispatch", cand.backend, batch)
            problem = Problem(batch.extents, batch.kind, batch.precision,
                              batch=bucket)
            bufs = self._buffers[threading.current_thread().name]
            slot = bufs.acquire(*_slot_bytes(problem))
            host_in = self._stage(batch, slot, problem)
            out, finite, event = self._issue(bufs, slot, host_in, transform)
        except Exception as e:
            if slot is not None:
                if bufs.stream is not None:
                    # a copy issued before the failure may still read the
                    # slab: the next refill waits for it
                    slot.event = torch.cuda.Event()
                    slot.event.record(bufs.stream)
                slot.busy = False
            self._handle_failure(batch, self._kernel_error(e, cand, batch),
                                 cand)
            return None
        self.metrics.on_batch(batch.n_requests, rows, bucket - rows)
        self._served[problem.signature()] = cand.key()
        spans = []
        r0 = 0
        for req in live:
            spans.append((r0, r0 + req.rows))
            r0 += req.rows
        return _Inflight(batch, out, finite, spans, now, cand, event, slot)

    def _stage(self, batch: Batch, slot: _Slot, problem: Problem
               ) -> torch.Tensor:
        """Copy the batch's rows into the slot's input slab (the slack rows
        of its bucket as zeros); returns the typed view."""
        host_in = _view(slot.inp, _TORCH_DTYPES[problem.input_dtype],
                        (problem.batch, *problem.extents))
        staged = host_in.numpy()
        r0 = 0
        for req in batch.requests:
            staged[r0:r0 + req.rows] = req.payload
            r0 += req.rows
        staged[r0:] = 0
        return host_in

    def _issue(self, bufs: _WorkerBuffers, slot: _Slot,
               host_in: torch.Tensor, transform):
        """The copy in, the transform, the finiteness probe (a flag per
        row: every element of the row finite) and the copy out on the
        worker's stream, without blocking; returns the output view, the
        flags' view (None with the probe off) and the event after the copy
        out (None on the CPU, where every step has finished)."""
        # Cross-stream lifetimes: the device input and output are allocated
        # here, inside the worker's stream context, and read only on that
        # stream, so the caching allocator reuses them only behind these
        # copies; the plan's tables were uploaded on the building thread's
        # stream and synchronized before the plan cache handed them out.
        # No tensor made on one stream is read on another, so none needs
        # ``record_stream``.
        with bufs.stream_ctx():
            x = host_in.to(self.device, non_blocking=True)
            y = transform(x)
            out = _view(slot.out, y.dtype, y.shape)
            out.copy_(y, non_blocking=True)
            finite = None
            if self.config.probe_output:
                finite = _view(slot.out, torch.bool, (y.shape[0],),
                               offset=out.numel() * out.element_size())
                finite.copy_(torch.isfinite(y).flatten(1).all(1),
                             non_blocking=True)
            event = None
            if bufs.stream is not None:
                event = torch.cuda.Event()
                event.record(bufs.stream)
        slot.event = event
        return out, finite, event

    def _retire(self, inflight: _Inflight) -> None:
        batch = inflight.batch
        cand = inflight.cand
        try:
            try:
                rules = self._apply_faults(
                    "execute", cand.backend if cand else "*", batch)
                for rule in rules:
                    if rule.fault == "execute_error":
                        raise FaultInjected(
                            f"injected execute error: "
                            f"{cand.key() if cand else '?'} @ "
                            f"{format_extents(batch.extents)}")
                if inflight.event is not None:
                    inflight.event.synchronize()
                host_out = inflight.out.numpy()
                nan_rules = [r for r in rules if r.fault == "nan_output"]
                if nan_rules:
                    host_out = np.array(host_out)   # corrupt a private copy
                    for rule in nan_rules:
                        if rule.rid is None:
                            host_out[:] = np.nan
                        else:
                            for req, (r0, r1) in zip(batch.requests,
                                                     inflight.row_spans):
                                if req.rid == rule.rid:
                                    host_out[r0:r1] = np.nan
                finite = self._probe(inflight, host_out, bool(nan_rules))
                self._deliver(inflight, host_out, finite)
            finally:
                inflight.slot.busy = False
        except Exception as e:
            self._handle_failure(batch, self._kernel_error(e, cand, batch),
                                 cand)

    def _probe(self, inflight: _Inflight, host_out: np.ndarray,
               corrupted: bool) -> Optional[np.ndarray]:
        """The retired batch's row flags (None with the probe off): the
        device's, and where an injected ``nan_output`` corrupted the host
        copy, that copy's own rows probed too."""
        if inflight.finite is None:
            return None
        finite = inflight.finite.numpy()
        if corrupted:
            finite = finite & np.isfinite(
                host_out.reshape(len(finite), -1)).all(1)
        return finite

    def _deliver(self, inflight: _Inflight, host_out: np.ndarray,
                 finite: Optional[np.ndarray]) -> None:
        """Complete each request of a retired batch with its own copy of
        its rows (result reuse: the slab is refilled by a later batch); a
        request with a non-finite row is retried or failed alone."""
        batch, cand = inflight.batch, inflight.cand
        now = time.perf_counter()
        problem = Problem(batch.extents, batch.kind, batch.precision)
        any_ok = False
        for req, (r0, r1) in zip(batch.requests, inflight.row_spans):
            if req.expired(now):
                limit = ((req.deadline - req.t_enqueue) * 1e3
                         if req.deadline is not None else float("nan"))
                self._fail(req, RequestTimeout(
                    f"request {req.rid} missed its {limit:.0f} ms deadline "
                    f"(completed {req.latency_ms:.1f} ms after enqueue)"),
                    timeout=True)
                continue
            out = host_out[r0:r1]
            if finite is not None and not finite[r0:r1].all():
                # 'computed garbage': per request, so a poison payload in a
                # coalesced batch fails alone
                self._retry_or_fail(req, ServeError(
                    f"non-finite output from "
                    f"{cand.key() if cand else 'engine'} for request "
                    f"{req.rid}"))
                continue
            req._complete(result=out.copy())
            any_ok = True
            self.metrics.on_complete(req.latency_ms, req.queue_ms,
                                     req.signal_bytes,
                                     retried=req.attempts > 0)
            self._record(req, success=True)
        if any_ok and cand is not None:
            # a delivered batch is the half-open probe's success signal
            self.breaker.record_success(breaker_key(cand.backend, problem))

    # --- failure handling --------------------------------------------------
    def _kernel_error(self, err: Exception, cand: Optional[Candidate],
                      batch: Batch) -> Exception:
        """On the card, a real failure of a kernel joins ``worker_errors``
        and becomes a :class:`KernelFault` naming the kernel; any other
        error is returned as it is."""
        if cand is None or not self._is_kernel_fault(err):
            return err
        self._worker_errors.append(err)
        return KernelFault(cand, Problem(batch.extents, batch.kind,
                                         batch.precision), err)

    def _handle_failure(self, batch: Batch, err: Exception,
                        cand: Optional[Candidate]) -> None:
        """A batch failed at dispatch or execute.  Book the failure against
        the candidate's breaker entry (not a kernel's real failure on the
        card: that must not quarantine the kernel), then isolate:
        multi-request batches bisect, single requests retry with backoff or
        fail cleanly."""
        problem = Problem(batch.extents, batch.kind, batch.precision)
        if cand is not None and not isinstance(err, KernelFault):
            state = self.breaker.record_failure(
                breaker_key(cand.backend, problem))
            if state == CircuitBreaker.OPEN \
                    and not (cand.backend == "xla" and not cand.axes):
                self._record_demotion(problem, cand.backend)
        reqs = list(batch.requests)
        if len(reqs) > 1 and self.config.bisect_batches:
            self.metrics.on_bisect()
            mid = len(reqs) // 2
            for half in (reqs[:mid], reqs[mid:]):
                sub = Batch(key=batch.key, requests=list(half))
                inflight = self._dispatch(sub)
                if inflight is not None:
                    self._retire(inflight)   # synchronous: bounded depth
        else:
            for req in reqs:
                self._retry_or_fail(req, err)

    def _retry_or_fail(self, req: FFTRequest, err: Exception) -> None:
        retryable = getattr(err, "retryable", True)
        if retryable and req.retries_left > 0 and not self.queue.closed \
                and not req.expired():
            req.retries_left -= 1
            req.attempts += 1
            self.metrics.on_retry()
            timer = threading.Timer(self._backoff_s(req), self._requeue,
                                    args=(req,))
            timer.daemon = True
            timer.start()
            return
        if isinstance(err, RequestTimeout):
            self._fail(req, err, timeout=True)
        elif isinstance(err, ServeError):
            self._fail(req, err)
        else:
            self._fail(req, ServeError(
                f"engine error: {type(err).__name__}: {err}"))

    def _backoff_s(self, req: FFTRequest) -> float:
        """Jittered exponential backoff: doubles per attempt up to the cap,
        scaled by a deterministic per-(request, attempt) factor in
        [0.5, 1.0) so retry storms decorrelate reproducibly."""
        base = self.config.backoff_base_ms * (2 ** max(0, req.attempts - 1))
        jitter = random.Random((req.rid << 8) ^ req.attempts).uniform(0.5, 1.0)
        return min(base, self.config.backoff_max_ms) * jitter / 1e3

    def _requeue(self, req: FFTRequest) -> None:
        if not self.queue.requeue(req):
            self._fail(req, ServeError(
                f"request {req.rid} dropped: service stopped before its "
                f"retry could run"))

    def _record_demotion(self, problem: Problem, backend: str) -> None:
        """Persist an opened quarantine to wisdom (best-effort) so warm
        sessions skip the known-bad pick outright."""
        self.metrics.on_demotion()
        if self.wisdom is None:
            return
        try:
            self.wisdom.record_demotion(problem, backend)
            self.wisdom.save()
        except Exception as e:       # persistence must never kill serving
            self._worker_errors.append(e)

    # --- plans and builds --------------------------------------------------
    def _cost_model_cm(self):
        """Scoped install of the config's fitted coefficient table (no-op
        without one): request-time plans and fallback-chain rankings both
        run under it."""
        if not self.config.costmodel:
            return nullcontext()
        from ..core.costmodel import model_for_device, use_model

        if self._cost_model is None:
            self._cost_model = model_for_device(self.session.device_kind,
                                                self.config.costmodel)
        return use_model(self._cost_model)

    def _plan_candidate(self, problem: Problem) -> Candidate:
        if self.config.backend is not None:
            return Candidate(self.config.backend)
        rigor = PlanRigor(self.config.rigor)
        cache = self.session.plan_cache
        key = PlanCache.plan_key(self.session.device_kind, problem, rigor,
                                 scope="serve")
        with self._cost_model_cm():
            plan, _ = cache.plan(
                key, lambda: make_plan(problem, rigor, wisdom=self.wisdom))
        if plan is None:
            raise ServeError(f"NULL plan for {problem.signature()} "
                             f"(wisdom miss under wisdom_only rigor)")
        return plan.candidate

    def _plan_chain(self, problem: Problem) -> list[Candidate]:
        """The ordered candidates this problem may be served with: the
        planner's pick first, then (with fallback on) every other feasible
        candidate by modeled cost, ``xla`` guaranteed present."""
        top = self._plan_candidate(problem)
        if not self.config.fallback or self.config.backend is not None:
            # pinned backends never fall back: a per-library bench must fail
            # honestly rather than quietly serve another library's numbers
            return [top]
        ckey = problem.signature()
        with self._chains_lock:
            rest = self._chains.get(ckey)
        if rest is None:
            with self._cost_model_cm():
                rest = fallback_chain(problem)
            with self._chains_lock:
                self._chains[ckey] = rest
        return [top] + [c for c in rest if c.key() != top.key()]

    def served_plans(self) -> dict[str, str]:
        """The candidate key each (problem, bucket) was last dispatched
        with, by problem signature: the planner's picks after any
        demotion."""
        return dict(self._served)

    def _executable(self, batch: Batch, bucket: int
                    ) -> tuple[Candidate, Any]:
        """The built transform for this plan at the bucket batch size,
        built once per (plan, bucket) through the shared single-flight
        PlanCache.  Takes :func:`walk_fallback_chain`: a candidate whose
        build fails (or that is quarantined / wisdom-demoted) demotes to
        the next, and the terminal candidate is tried regardless.  On the
        card a kernel that raises while building is not demoted past
        (``KernelFault``).

        Donation (``donate_argnums`` in the reference) is a JAX mechanism
        with no counterpart here: the transform allocates its output from
        the caching allocator on the worker's stream."""
        problem = Problem(batch.extents, batch.kind, batch.precision,
                          batch=bucket)

        def build(cand: Candidate):
            def make():
                self._apply_faults("build", cand.backend, batch)
                t = _forward_fn(problem, cand, self.device)
                if self.device.type == "cuda":
                    # the tables are uploaded on this thread's stream: no
                    # worker stream may read them half-written
                    torch.cuda.synchronize(self.device)
                return t

            key = PlanCache.executable_key(self.session.device_kind, problem,
                                           cand, "serve_forward")
            return self.session.plan_cache.executable(key, make)[0]

        def kernel_error(cand: Candidate, err: Exception):
            if not self._is_kernel_fault(err):
                return None
            self._worker_errors.append(err)
            return KernelFault(cand, problem, err)

        def on_failure(cand: Candidate, opened: bool) -> None:
            if opened:
                self._record_demotion(problem, cand.backend)
            else:
                self.metrics.on_demotion()

        cand, built, _ = walk_fallback_chain(
            problem, self._plan_chain(problem), build, self.breaker,
            demoted=(self.wisdom.demoted(problem)
                     if self.wisdom is not None else frozenset()),
            kernel_error=kernel_error, on_failure=on_failure,
            record_success=False)   # a delivered batch records it
        return cand, built

    # --- bookkeeping -------------------------------------------------------
    def _fail(self, req: FFTRequest, err: ServeError,
              timeout: bool = False) -> None:
        req._complete(error=err)
        self.metrics.on_error(timeout=timeout)
        self._record(req, success=False, error=str(err))

    def _record(self, req: FFTRequest, success: bool,
                error: str = "") -> None:
        if not self.config.record_requests:
            return
        row = Row(library=LIBRARY, device=self.session.device_kind,
                  extents=format_extents(req.extents),
                  rank=len(req.extents),
                  extent_class=classify(req.extents),
                  precision=req.precision, kind=req.kind,
                  rigor=self.config.rigor, run=req.rid, op="serve_request",
                  time_ms=req.latency_ms if success else 0.0,
                  bytes=req.signal_bytes, success=success, error=error)
        with self._rows_lock:
            self._rows.append(row)

    def rows(self) -> list[Row]:
        """Per-request result rows (op ``serve_request``; failed requests
        carry their error): feed them to a ResultSet for the shared
        percentile aggregation."""
        with self._rows_lock:
            return list(self._rows)

    def result_set(self):
        from ..core.results import columns_for
        from ..core.suite import ResultSet

        return ResultSet(self.rows(), columns_for(False),
                         plan_stats=self.session.plan_cache.stats)

    def report(self) -> dict:
        """Metrics snapshot: the shared plan cache's counters, the
        quarantine (circuit breaker) states, worker errors, and (with a
        FaultPlan attached) the injected-fault accounting."""
        snap = self.metrics.snapshot(
            plan_stats=self.session.plan_cache.stats,
            quarantine=self.breaker.snapshot())
        snap["worker_errors"] = [f"{type(e).__name__}: {e}"
                                 for e in self._worker_errors]
        if self.fault_plan is not None:
            snap["faults"] = self.fault_plan.snapshot()
        return snap
