"""The port's FFT serving layer (``repro_torch.serve``) against the
reference package's (``repro.serve``), on a CPU session, where the kernels
run their plain versions.

* every test of ``tests/test_serve.py`` held against the port: queue and
  coalescer mechanics, end-to-end correctness against numpy, timeouts and
  engine errors, fault tolerance (fallback, retries, bisection, watchdog,
  wedge detection), traffic replay, the percentile plumbing, the
  ``TorchServeFFT`` client through ``Session.run``, and concurrency
  hammers of the shared PlanCache and wisdom store;
* equal to the reference's: ``TrafficSpec`` tapes and payloads (byte for
  byte), the specs' dicts and validation errors, the percentile helpers
  and ``aggregate_rows(percentiles=True)``, the client's schedule;
* the same seeded replay through the reference's service (JAX on the CPU)
  and the port's: each request's output within 1e-3 (float) and 1e-8
  (double) rel-L2, and a pinned ``stockham_pallas`` replay against the
  reference's, whose kernel runs in interpret mode;
* the hazards torch adds (staging and output slabs reused across batches
  and workers) and the card-only rule that a kernel's real failure is not
  demoted past, through a stub device check.

No assertion reads a wall-clock time; every wait has a timeout.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import results as rresults
from repro.core.clients import serve_fft as rserve_fft
from repro.serve import FFTService as RFFTService
from repro.serve import ServeConfig as RServeConfig
from repro.serve import TrafficSpec as RTrafficSpec
from repro.serve import replay as rreplay
from repro.serve.replay import _payloads as r_payloads
from repro_torch.core.client import Problem, TorchContext
from repro_torch.core.clients import serve_fft
from repro_torch.core.plan import Candidate, Plan, PlanCache, PlanRigor
from repro_torch.core.results import (Row, aggregate_rows, columns_for,
                                      percentile, percentile_summary)
from repro_torch.core.suite import Session, SuiteSpec
from repro_torch.core.wisdom import Wisdom
from repro_torch.serve import (Coalescer, FaultPlan, FFTService, QueueFull,
                               RequestQueue, RequestTimeout, ServeConfig,
                               ServeError, TrafficSpec, WorkerWedged,
                               chaos_replay, make_request, replay)
from repro_torch.serve import engine as pengine
from repro_torch.serve.replay import _payloads

TOL = {"float": 1e-3, "double": 1e-8}


def _session(**options):
    return Session(TorchContext("cpu", options))


def _payload(ext=(64,), rows=None, dtype=np.complex64, seed=0):
    """A transform input: shape ``ext``, or ``(rows, *ext)`` when a request
    should occupy several batch rows (submit those with ``rank=len(ext)``)."""
    rng = np.random.default_rng(seed)
    shape = ext if rows is None else (rows, *ext)
    x = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _service(wisdom=None, fault_plan=None, **kw):
    kw.setdefault("coalesce_window_ms", 2.0)
    kw.setdefault("max_batch", 8)
    return FFTService(_session(), config=ServeConfig(**kw), wisdom=wisdom,
                      fault_plan=fault_plan)


class _Gated(FFTService):
    """The engine with its workers held until ``n`` requests are queued: a
    burst submitted one request at a time then coalesces whatever the
    scheduler does."""

    def __init__(self, *args, n: int, **kwargs):
        super().__init__(*args, **kwargs)
        self._n = n
        self._gate = threading.Event()

    def _worker_loop(self) -> None:
        self._gate.wait(timeout=60)
        super()._worker_loop()

    def submit(self, *args, **kwargs):
        req = super().submit(*args, **kwargs)
        if len(self.queue) >= self._n:
            self._gate.set()
        return req


class _Stalled(FFTService):
    """The engine with its injected stall held until the test releases it,
    and an event that says the worker is in it."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.entered = threading.Event()
        self.release = threading.Event()

    def _stall(self, seconds: float) -> None:
        self.entered.set()
        self.release.wait(timeout=seconds)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _rows(n=10):
    return [Row(library="L", device="d", extents="8", rank=1,
                extent_class="powerof2", precision="float",
                kind="Outplace_Complex", rigor="estimate", run=i,
                op="execute_forward", time_ms=float(i + 1), bytes=0)
            for i in range(n)]


# ---------------------------------------------------------------------------
# percentile math (results.py)
# ---------------------------------------------------------------------------
def test_percentile_matches_numpy_linear_interpolation():
    rng = np.random.default_rng(42)
    vals = list(rng.standard_normal(37) * 10)
    for q in (0, 25, 50, 75, 95, 99, 100):
        assert percentile(vals, q) == pytest.approx(
            float(np.percentile(vals, q)), rel=1e-12)
        assert percentile(vals, q) == rresults.percentile(vals, q)


def test_percentile_summary_keys_and_single_sample():
    s = percentile_summary([3.0])
    assert s == {"p50": 3.0, "p95": 3.0, "p99": 3.0}
    assert percentile([1.0, 2.0], 50) == pytest.approx(1.5)
    vals = list(np.random.default_rng(1).random(23))
    assert percentile_summary(vals) == rresults.percentile_summary(vals)


def test_aggregate_rows_percentiles_opt_in_preserves_default_shape():
    rows = _rows()
    default = aggregate_rows(rows, op="execute_forward")
    assert len(default[0]) == 9                      # legacy 9-tuple intact
    wide = aggregate_rows(rows, op="execute_forward", percentiles=True)
    (*key, mean, sd, p50, p95, p99, n) = wide[0]
    assert n == 10 and mean == pytest.approx(5.5)
    assert p50 == pytest.approx(np.percentile(range(1, 11), 50))
    assert p99 == pytest.approx(np.percentile(range(1, 11), 99))


@pytest.mark.parametrize("percentiles", [False, True])
def test_aggregate_rows_are_the_reference(percentiles):
    fields = [r.as_dict(columns_for(False)) for r in _rows(12)]
    ref = rresults.aggregate_rows([rresults.Row(**f) for f in fields],
                                  op="execute_forward",
                                  percentiles=percentiles)
    assert aggregate_rows(_rows(12), op="execute_forward",
                          percentiles=percentiles) == ref


# ---------------------------------------------------------------------------
# request + queue mechanics
# ---------------------------------------------------------------------------
def test_make_request_infers_precision_and_rank():
    req = make_request(_payload((16,), dtype=np.complex128))
    assert req.precision == "double" and req.extents == (16,)
    assert req.rows == 1
    req = make_request(_payload((4, 8), rows=2), rank=2)
    assert req.extents == (4, 8) and req.rows == 2
    with pytest.raises(ValueError):
        make_request(np.zeros((4,), np.int32))


def test_queue_backpressure_and_load_shed():
    q = RequestQueue(maxsize=2)
    q.put(make_request(_payload()))
    q.put(make_request(_payload()))
    with pytest.raises(QueueFull):
        q.put(make_request(_payload()), block=False)
    with pytest.raises(QueueFull):
        q.put(make_request(_payload()), timeout=0.01)
    assert q.get(timeout=0.01) is not None
    q.put(make_request(_payload()), block=False)    # space again


def test_queue_put_many_is_all_or_nothing():
    q = RequestQueue(maxsize=3)
    q.put_many([make_request(_payload()) for _ in range(3)])
    with pytest.raises(QueueFull):
        q.put_many([make_request(_payload())], block=False)
    assert len(q) == 3
    q.close()
    with pytest.raises(QueueFull):
        q.put_many([make_request(_payload())])


def test_queue_close_drains_then_none():
    q = RequestQueue()
    q.put(make_request(_payload()))
    q.close()
    assert q.get(timeout=0.1) is not None   # drain what remains
    assert q.get(timeout=0.1) is None       # then the shutdown signal


def test_coalescer_groups_same_plan_only():
    q = RequestQueue()
    a1 = make_request(_payload((32,)))
    b = make_request(_payload((64,)))
    a2 = make_request(_payload((32,)))
    for r in (a1, b, a2):
        q.put(r)
    c = Coalescer(q, window_ms=0.0, max_rows=8)
    batch = c.next_batch()
    assert [r.rid for r in batch.requests] == [a1.rid, a2.rid]
    assert batch.rows == 2 and batch.extents == (32,)
    assert c.next_batch().requests == [b]


def test_coalescer_respects_row_budget():
    q = RequestQueue()
    reqs = [make_request(_payload((16,), rows=2), rank=1) for _ in range(4)]
    for r in reqs:
        q.put(r)
    c = Coalescer(q, window_ms=0.0, max_rows=5)
    batch = c.next_batch()
    assert batch.rows == 4 and batch.n_requests == 2   # 3rd would exceed 5
    assert c.next_batch().rows == 4


def test_serial_fifo_when_coalescing_disabled():
    q = RequestQueue()
    reqs = [make_request(_payload((16,))) for _ in range(3)]
    for r in reqs:
        q.put(r)
    c = Coalescer(q, window_ms=0.0, max_rows=1)
    got = [c.next_batch().requests[0].rid for _ in range(3)]
    assert got == [r.rid for r in reqs]


# ---------------------------------------------------------------------------
# end-to-end service correctness
# ---------------------------------------------------------------------------
def test_service_burst_matches_numpy_and_coalesces():
    xs = [_payload((128,), seed=i) for i in range(6)]
    with _Gated(_session(), ServeConfig(coalesce_window_ms=10.0, max_batch=8),
                n=len(xs)) as svc:
        reqs = [svc.submit(x) for x in xs]
        outs = [np.asarray(r.result(timeout=300)) for r in reqs]
    for x, y in zip(xs, outs):
        ref = np.fft.fft(x)
        assert np.max(np.abs(y[0] - ref)) / np.max(np.abs(ref)) < 1e-3
    rep = svc.report()
    assert rep["completed"] == 6 and rep["errors"] == 0
    assert rep["batches"] < 6 and rep["coalesce_rate"] > 0
    assert {"p50", "p95", "p99"} <= set(rep["latency_ms"])


def test_service_mixed_shapes_kinds_precisions():
    jobs = [
        (_payload((64,), dtype=np.complex64), "Outplace_Complex"),
        (_payload((32, 16), dtype=np.complex128), "Outplace_Complex"),
        (_payload((64,), dtype=np.float32), "Outplace_Real"),
        (_payload((128,), dtype=np.float64), "Outplace_Real"),
    ]
    with _service() as svc:
        reqs = [svc.submit(x, kind=k) for x, k in jobs]
        outs = [np.asarray(r.result(timeout=300)) for r in reqs]
    for (x, kind), y in zip(jobs, outs):
        if kind == "Outplace_Complex":
            ref = np.fft.fftn(x.astype(np.complex128))
        else:
            ref = np.fft.rfftn(x.astype(np.float64))
        tol = 1e-3 if x.dtype.itemsize <= 8 else 1e-9
        assert np.max(np.abs(y[0] - ref)) / np.max(np.abs(ref)) < tol


def test_submit_many_returns_futures_in_order():
    xs = [_payload((32,), seed=i) for i in range(5)]
    with _service() as svc:
        reqs = svc.submit_many(xs)
        outs = [np.asarray(r.result(timeout=300)) for r in reqs]
    for x, y in zip(xs, outs):
        assert np.allclose(y[0], np.fft.fft(x), rtol=1e-3, atol=1e-3)


def test_request_timeout_fails_cleanly_and_worker_survives():
    with _service(timeout_ms=0.0) as svc:      # every request pre-expired
        req = svc.submit(_payload((32,)))
        with pytest.raises(RequestTimeout):
            req.result(timeout=60)
        # the worker must still serve fresh (un-expired) work
        ok = svc.submit(_payload((32,)), timeout_ms=60_000)
        assert ok.result(timeout=300) is not None
    rep = svc.report()
    assert rep["timeouts"] == 1 and rep["completed"] == 1
    failed = [r for r in svc.rows() if not r.success]
    assert len(failed) == 1 and "expired" in failed[0].error
    assert failed[0].library == "TorchServeFFT"


def test_engine_error_fails_batch_not_worker():
    with _service(backend="fft2_pallas") as svc:   # rank-2 only: 1D must fail
        bad = svc.submit(_payload((32,)))
        with pytest.raises(ServeError, match="engine error"):
            bad.result(timeout=300)
        good = svc.submit(_payload((8, 8), dtype=np.complex64))
        assert good.result(timeout=300) is not None
    assert svc.report()["errors"] == 1


def test_submit_validates_rows_and_started():
    svc = _service(max_batch=2)
    with pytest.raises(ServeError, match="not started"):
        svc.submit(_payload((16,)))
    with svc:
        with pytest.raises(ServeError, match="exceed max_batch"):
            svc.submit(_payload((16,), rows=4), rank=1)


def test_prewarm_compiles_bucket_ladder():
    with _service(max_batch=8) as svc:
        n = svc.prewarm((32,))
        assert n == 4                         # buckets 1, 2, 4, 8
        stats = svc.session.plan_cache.stats
        misses0 = stats.misses
        svc.submit(_payload((32,))).result(timeout=300)
        assert stats.misses == misses0        # served entirely warm


def test_serve_config_roundtrip_and_validation():
    cfg = ServeConfig(max_batch=4, workers=2, backend="xla")
    assert ServeConfig.from_dict(cfg.to_dict()) == cfg
    with pytest.raises(ValueError, match="unknown ServeConfig"):
        ServeConfig.from_dict({"max_batch": 4, "nope": 1})
    with pytest.raises(ValueError):
        ServeConfig(max_batch=0)
    with pytest.raises(ValueError):
        ServeConfig(rigor="bogus")


CONFIGS = [{}, {"max_batch": 4, "workers": 2, "backend": "xla"},
           {"max_retries": 5, "breaker_threshold": 2, "costmodel": "t.json",
            "faults": ({"fault": "latency_spike", "stall_ms": 1.0},)}]
BAD_CONFIGS = [{"max_batch": 0}, {"rigor": "bogus"}, {"max_retries": -1},
               {"nope": 1}, {"faults": ({"fault": "gremlins"},)}]


@pytest.mark.parametrize("kw", CONFIGS)
def test_serve_config_dicts_are_the_reference(kw):
    assert ServeConfig(**kw).to_dict() == RServeConfig(**kw).to_dict()


@pytest.mark.parametrize("kw", BAD_CONFIGS)
def test_serve_config_errors_are_the_reference(kw):
    with pytest.raises((ValueError, TypeError)) as mine:
        ServeConfig.from_dict(kw)
    with pytest.raises((ValueError, TypeError)) as ref:
        RServeConfig.from_dict(kw)
    assert type(mine.value) is type(ref.value)
    assert str(mine.value).split(":")[0] == str(ref.value).split(":")[0]


# ---------------------------------------------------------------------------
# fault tolerance: fallback, retry, bisection, watchdog, wedge detection
# ---------------------------------------------------------------------------
def test_engine_falls_back_past_compile_fault_and_persists_demotion(tmp_path):
    from repro_torch.core.plan import fallback_chain

    top = fallback_chain(Problem((64,), "Outplace_Complex", "float")).pop(0)
    wisdom = Wisdom(str(tmp_path / "wisdom.json"), device_kind="cpu")
    svc = _service(max_batch=8, breaker_threshold=1, wisdom=wisdom,
                   fault_plan=FaultPlan([{"fault": "compile_error",
                                          "backend": top.backend}]))
    with svc:
        x = _payload((64,))
        out = np.asarray(svc.submit(x).result(timeout=300))
    assert np.allclose(out[0], np.fft.fft(x), rtol=1e-3, atol=1e-3)
    rep = svc.report()
    assert rep["completed"] == 1 and rep["errors"] == 0
    assert rep["demotions"] >= 1 and rep["faults_injected"] >= 1
    # the quarantine shows up in the report and survived to wisdom on disk
    assert any(k.startswith(top.backend) and v["state"] == "open"
               for k, v in rep["quarantine"].items())
    fresh = Wisdom(str(tmp_path / "wisdom.json"), device_kind="cpu")
    assert top.backend in fresh.demoted(
        Problem((64,), "Outplace_Complex", "float"))


def test_poison_request_fails_alone_batchmates_succeed():
    xs = [_payload((32,), seed=i) for i in range(4)]
    reqs = [make_request(x) for x in xs]
    poison = reqs[1]
    svc = _service(coalesce_window_ms=20.0)
    svc.fault_plan = FaultPlan([{"fault": "execute_error",
                                 "rid": poison.rid}])
    with svc:
        svc.queue.put_many(reqs)      # one coalesced batch, rids known
        with pytest.raises(ServeError, match="injected execute error"):
            poison.result(timeout=300)
        for i, req in enumerate(reqs):
            if req is poison:
                continue
            out = np.asarray(req.result(timeout=300))
            ref = np.fft.fft(xs[i])
            assert np.max(np.abs(out[0] - ref)) / np.max(np.abs(ref)) < 1e-2
    rep = svc.report()
    assert rep["completed"] == 3 and rep["errors"] == 1
    assert rep["bisections"] >= 2     # 4 -> 2+2 -> 1+1: poison isolated


def test_transient_fault_recovered_by_retry():
    svc = _service(faults=({"fault": "execute_error", "times": 2},),
                   max_retries=3)
    with svc:
        req = svc.submit(_payload((32,)))
        out = np.asarray(req.result(timeout=300))
    assert out is not None and req.ok and req.attempts >= 1
    rep = svc.report()
    assert rep["completed"] == 1 and rep["errors"] == 0
    assert rep["retries"] >= 1 and rep["retry_successes"] >= 1
    assert rep["faults_injected"] == 2


def test_kill_worker_watchdog_restarts_and_service_survives():
    svc = _service(faults=({"fault": "kill_worker", "times": 1},),
                   watchdog_interval_s=0.05)
    with svc:
        doomed = svc.submit(_payload((32,)))
        with pytest.raises(ServeError, match="failed by watchdog"):
            doomed.result(timeout=60)
        dead = "fft-serve-0"
        ok = svc.submit(_payload((32,)))     # the restarted worker serves it
        assert ok.result(timeout=300) is not None
        # the replacement has its own buffers; the dead worker's are gone
        assert dead not in svc._buffers and len(svc._buffers) == 1
    rep = svc.report()
    assert rep["worker_restarts"] >= 1 and rep["completed"] == 1
    assert any("WorkerKilled" in e for e in rep["worker_errors"])
    assert rep["wedged"] == 0


def test_stop_reports_wedged_worker():
    svc = _Stalled(_session(), ServeConfig(
        faults=({"fault": "transfer_stall", "stall_ms": 60_000.0,
                 "times": 1},),
        join_timeout_s=0.2, drain_timeout_s=0.2, watchdog_interval_s=0.0))
    svc.start()
    req = svc.submit(_payload((32,)))
    try:
        assert svc.entered.wait(timeout=60)     # the worker is in the stall
        with pytest.raises(WorkerWedged, match="failed to join") as ei:
            svc.stop()
    finally:
        svc.release.set()
    assert ei.value.snapshot["wedged_workers"]
    assert ei.value.snapshot["wedged"] >= 1
    req.result(timeout=60)            # the stalled worker still finishes it


def test_nan_output_fault_fails_only_its_own_request():
    """An injected ``nan_output`` on one request of a coalesced batch is
    caught by the probe at retire: that request is retried, then fails;
    its batchmates are delivered."""
    xs = [_payload((32,), seed=i) for i in range(4)]
    reqs = [make_request(x, retries=1) for x in xs]
    poison = reqs[2]
    svc = _service(coalesce_window_ms=20.0, max_retries=1,
                   fault_plan=FaultPlan([{"fault": "nan_output",
                                          "rid": poison.rid, "times": -1}]))
    with svc:
        svc.queue.put_many(reqs)      # one coalesced batch
        with pytest.raises(ServeError, match="non-finite output"):
            poison.result(timeout=300)
        for x, req in zip(xs, reqs):
            if req is not poison:
                assert _rel_l2(req.result(timeout=300)[0],
                               np.fft.fft(x)) <= 1e-3
    rep = svc.report()
    assert rep["completed"] == 3 and rep["errors"] == 1
    assert rep["retries"] == 1 and rep["faults_injected"] == 2


@pytest.mark.parametrize("probe", [True, False])
def test_probe_flags_a_non_finite_request_alone(probe):
    """A payload whose transform is not finite fails alone when the probe
    (a flag per row, computed beside the transform) is on, and is
    delivered as computed when it is off."""
    xs = [_payload((32,), rows=2, seed=i) for i in range(3)]
    xs[1][1, 5] = np.inf
    reqs = [make_request(x, rank=1, retries=1) for x in xs]
    svc = _service(coalesce_window_ms=20.0, max_retries=1,
                   probe_output=probe)
    with svc:
        svc.queue.put_many(reqs)
        if probe:
            with pytest.raises(ServeError, match="non-finite output"):
                reqs[1].result(timeout=300)
        else:
            assert not np.isfinite(reqs[1].result(timeout=300)).all()
        for i in (0, 2):
            assert _rel_l2(reqs[i].result(timeout=300),
                           np.fft.fft(xs[i], axis=-1)) <= 1e-3
    rep = svc.report()
    assert rep["errors"] == (1 if probe else 0)
    assert rep["completed"] == (2 if probe else 3)


def test_failure_messages_carry_actionable_context():
    q = RequestQueue(maxsize=2)
    q.put(make_request(_payload()))
    q.put(make_request(_payload()))
    with pytest.raises(QueueFull, match=r"2/2 requests pending"):
        q.put(make_request(_payload()), block=False)
    with pytest.raises(QueueFull, match=r"after waiting 0.01s"):
        q.put(make_request(_payload()), timeout=0.01)
    with _service(timeout_ms=0.0) as svc:
        req = svc.submit(_payload((32,)))
        with pytest.raises(RequestTimeout, match=r"0 ms deadline"):
            req.result(timeout=60)
    assert "queue depth" in str(req.error)


def test_serve_config_fault_fields_roundtrip_and_validation():
    cfg = ServeConfig(max_retries=5, breaker_threshold=2,
                      faults=({"fault": "latency_spike", "stall_ms": 1.0},))
    assert ServeConfig.from_dict(cfg.to_dict()) == cfg
    assert "faults" not in ServeConfig().to_dict()
    with pytest.raises(ValueError):
        ServeConfig(max_retries=-1)
    with pytest.raises(ValueError):
        ServeConfig(breaker_threshold=0)
    with pytest.raises(ValueError, match="unknown fault"):
        ServeConfig(faults=({"fault": "gremlins"},))


def test_chaos_replay_grades_recovery():
    from repro_torch.core.plan import fallback_chain

    top = fallback_chain(Problem((64,), "Outplace_Complex", "float")).pop(0)
    spec = TrafficSpec(extents=((64,), (32,)), requests=10, seed=11,
                       faults=({"fault": "compile_error",
                                "backend": top.backend},
                               {"fault": "execute_error", "after": 1,
                                "times": 1}))
    svc = _service(coalesce_window_ms=2.0, max_batch=8, breaker_threshold=1)
    with svc:
        rep = chaos_replay(svc, spec)
    assert rep.ok, rep.violations
    assert rep.total == 10 and rep.poisoned == 0
    assert rep.clean_success_rate == 1.0
    assert rep.faults["injected"] >= 2
    assert rep.replay.service["demotions"] >= 1
    json.dumps(rep.to_dict())


class _CardBuild(FFTService):
    """The engine with its device check stubbed to the card's: a build
    that raises is a hand-written kernel's real failure."""

    def _on_card(self) -> bool:
        return True


@pytest.mark.parametrize("card", [False, True])
def test_a_kernel_fault_is_demoted_only_on_the_cpu(monkeypatch, card):
    """On the CPU a raising build demotes to the next candidate, as in the
    reference; on the card it is not demoted past: it joins
    ``worker_errors``, opens no quarantine, and fails its request with a
    message naming the kernel.  An injected fault demotes in both."""
    from repro_torch.core.plan import fallback_chain

    top = fallback_chain(Problem((64,), "Outplace_Complex", "float"))[0]
    real = pengine._forward_fn

    def failing(problem, cand, device):
        if cand.backend == top.backend:
            raise RuntimeError("launch failed: cudaErrorInvalidValue")
        return real(problem, cand, "cpu")

    monkeypatch.setattr(pengine, "_forward_fn", failing)
    cls = _CardBuild if card else FFTService
    svc = cls(_session(), ServeConfig(max_batch=8, breaker_threshold=1,
                                      max_retries=1))
    x = _payload((64,))
    with svc:
        req = svc.submit(x)
        if card:
            with pytest.raises(ServeError, match=f"kernel {top.backend}"):
                req.result(timeout=300)
        else:
            out = req.result(timeout=300)
            assert _rel_l2(out[0], np.fft.fft(x)) <= 1e-3
    rep = svc.report()
    if card:
        assert rep["demotions"] == 0 and rep["errors"] == 1
        assert rep["worker_errors"] and all(
            "cudaErrorInvalidValue" in e for e in rep["worker_errors"])
        assert all(v["state"] == "closed" and not v["failures"]
                   for v in rep["quarantine"].values())
    else:
        assert rep["demotions"] >= 1 and not rep["worker_errors"]
    # an injected fault is a fault the walk may demote past, on the card too
    svc = cls(_session(), ServeConfig(max_batch=8, breaker_threshold=1),
              fault_plan=FaultPlan([{"fault": "compile_error",
                                     "backend": top.backend}]))
    monkeypatch.setattr(pengine, "_forward_fn", real)
    with svc:
        svc._on_card = lambda: card
        out = svc.submit(x).result(timeout=300)
    assert _rel_l2(out[0], np.fft.fft(x)) <= 1e-3
    assert svc.report()["demotions"] >= 1


def test_service_with_no_session_needs_the_card():
    """``FFTService()`` serves on cuda:0; with no card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda:0 is not available"):
        FFTService()


# ---------------------------------------------------------------------------
# the hazards torch adds: staging and output slabs, several workers
# ---------------------------------------------------------------------------
def test_a_delivered_result_survives_later_batches():
    """A request's result is its own array: later batches refill the same
    staging and output slabs and leave it unchanged."""
    with _service(max_batch=4, coalesce_window_ms=0.0, inflight=1) as svc:
        first = svc.submit(_payload((64,), seed=0))
        got = first.result(timeout=300)
        kept = got.copy()
        slots = {id(s.out) for b in svc._buffers.values() for s in b.slots
                 if s.out is not None}
        for i in range(1, 9):
            svc.submit(_payload((64,), seed=i)).result(timeout=300)
        assert {id(s.out) for b in svc._buffers.values() for s in b.slots
                if s.out is not None} & slots   # the slabs were reused
    assert np.array_equal(got, kept)
    assert _rel_l2(got[0], np.fft.fft(_payload((64,), seed=0))) <= 1e-3


def test_two_workers_three_in_flight_deliver_every_result():
    spec = TrafficSpec(extents=((64,), (48,), (8, 8)),
                       kinds=("Outplace_Complex", "Outplace_Real"),
                       requests=40, batch=3, seed=8)
    with _service(max_batch=12, workers=2, inflight=3,
                  coalesce_window_ms=1.0) as svc:
        rep = replay(svc, spec, wait_timeout_s=300)
        assert len(svc._buffers) == 2
        assert all(len(b.slots) >= 4 for b in svc._buffers.values())
    assert rep.service["completed"] == 40 and rep.service["errors"] == 0
    payloads = _payloads(spec)
    for req in rep.requests:
        x = payloads[req.plan_key].astype(
            np.complex128 if req.kind.endswith("Complex") else np.float64)
        axes = tuple(range(-len(req.extents), 0))
        ref = (np.fft.fftn(x, axes=axes) if req.kind.endswith("Complex")
               else np.fft.rfftn(x, axes=axes))
        assert _rel_l2(req.result(timeout=60), ref) <= 1e-3


def test_stress_more_workers_than_cores():
    """More workers than cores, with short thread switches: every request
    gets its own payload's transform (a slab shared or reused too early
    would hand it another's rows), and the counters lose no update."""
    import os
    import sys

    workers = (os.cpu_count() or 4) + 1
    xs = [_payload((16,), rows=2, seed=i) for i in range(6 * workers)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _service(max_batch=4, workers=workers, inflight=2,
                      coalesce_window_ms=0.5) as svc:
            reqs = [svc.submit(x, rank=1) for x in xs]
            outs = [r.result(timeout=300) for r in reqs]
    finally:
        sys.setswitchinterval(interval)
    for x, y in zip(xs, outs):
        assert _rel_l2(y, np.fft.fft(x, axis=-1)) <= 1e-3
    rep = svc.report()
    assert rep["completed"] == rep["requests"] == len(xs)
    assert rep["errors"] == 0 and not rep["worker_errors"]


# ---------------------------------------------------------------------------
# traffic replay
# ---------------------------------------------------------------------------
def test_traffic_spec_roundtrip_and_validation():
    spec = TrafficSpec(extents=("256", (64, 64)), requests=10, rate_hz=50.0)
    assert spec.extents == ((256,), (64, 64))
    assert TrafficSpec.from_dict(spec.to_dict()) == spec
    with pytest.raises(ValueError, match="unknown TrafficSpec"):
        TrafficSpec.from_dict({"requests": 5, "bogus": 1})
    with pytest.raises(ValueError):
        TrafficSpec(kinds=("Sideways_Complex",))
    with pytest.raises(ValueError):
        TrafficSpec(requests=0)


def test_traffic_schedule_deterministic_and_zipf_skewed():
    spec = TrafficSpec(extents=((32,), (64,), (128,)), requests=200, seed=9)
    tape1, tape2 = list(spec.schedule()), list(spec.schedule())
    assert tape1 == tape2
    counts = {}
    for _, ext, _, _ in tape1:
        counts[ext] = counts.get(ext, 0) + 1
    assert counts[(32,)] > counts[(128,)]     # rank-1 entry is the hot one
    # burst mode: all arrivals at t=0
    assert all(t == 0.0 for t, *_ in tape1)


def _table_replay():
    from repro_torch.benchmarks import table_serve
    return table_serve.REPLAY


SPECS = {
    "table_serve": _table_replay,
    "open_loop": lambda: dict(extents=("256", "12x10", "97"),
                              kinds=("Outplace_Complex", "Inplace_Real"),
                              precisions=("float", "double"), requests=50,
                              rate_hz=120.0, zipf_s=0.7, batch=3, seed=5),
    "burst": lambda: dict(extents=("4096", "1024", "945", "128", "64x64"),
                          kinds=("Outplace_Complex", "Outplace_Real"),
                          precisions=("float",), batch=2, requests=160,
                          zipf_s=1.1, seed=2017,
                          faults=({"fault": "kill_worker", "after": 2,
                                   "times": 1},)),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_traffic_tapes_and_payloads_are_the_reference(name):
    made = SPECS[name]()
    mine = made if isinstance(made, TrafficSpec) else TrafficSpec(**made)
    ref = RTrafficSpec.from_dict(mine.to_dict())
    assert mine.to_dict() == ref.to_dict()
    assert list(mine.schedule()) == list(ref.schedule())
    assert np.array_equal(mine.weights(), ref.weights())
    a, b = _payloads(mine), r_payloads(ref)
    assert list(a) == list(b)
    for key in a:
        assert a[key].dtype == b[key].dtype
        assert a[key].tobytes() == b[key].tobytes()


@pytest.mark.parametrize("d", [{"requests": 5, "bogus": 1},
                               {"kinds": ["Sideways_Complex"]},
                               {"requests": 0}, {"extents": []},
                               {"rate_hz": -1.0}])
def test_traffic_spec_errors_are_the_reference(d):
    with pytest.raises(ValueError) as mine:
        TrafficSpec.from_dict(d)
    with pytest.raises(ValueError) as ref:
        RTrafficSpec.from_dict(d)
    assert str(mine.value) == str(ref.value)


def test_replay_end_to_end_report():
    spec = TrafficSpec(extents=((32,), (64,)), requests=12, rate_hz=0.0,
                       seed=5)
    with _Gated(_session(), ServeConfig(coalesce_window_ms=5.0, max_batch=8),
                n=spec.requests) as svc:
        rep = replay(svc, spec)
    assert rep.service["completed"] == 12
    assert rep.service["batches"] < 12        # burst traffic must coalesce
    assert {"p50", "p95", "p99"} <= set(rep.service["latency_ms"])
    assert sum(m["requests"] for m in rep.per_mix) == 12
    json.dumps(rep.to_dict())                 # report is JSON-clean


def test_replay_through_result_set_summary():
    spec = TrafficSpec(extents=((32,),), requests=6, seed=1)
    with _service() as svc:
        replay(svc, spec)
    summary = svc.result_set().summary(latency_op="serve_request")
    assert summary["latency_ms"]["n"] == 6
    assert {"p50", "p95", "p99"} <= set(summary["latency_ms"])


@pytest.mark.parametrize("precision", ["float", "double"])
def test_replay_gives_the_reference_services_outputs(precision):
    """The same seeded tape through the reference's service (``xla``, JAX
    on the CPU) and the port's planner: each request's output, matched by
    submission order, within the suite's bar."""
    spec = TrafficSpec(extents=("64", "48", "8x8"),
                       kinds=("Outplace_Complex", "Outplace_Real"),
                       precisions=(precision,), requests=16, batch=2, seed=7)
    with _service(max_batch=8) as svc:
        mine = replay(svc, spec, wait_timeout_s=300)
    with RFFTService(config=RServeConfig(max_batch=8, backend="xla")) as svc:
        ref = rreplay(svc, RTrafficSpec.from_dict(spec.to_dict()),
                      wait_timeout_s=300)
    assert len(mine.requests) == len(ref.requests) == 16
    for a, b in zip(mine.requests, ref.requests):
        assert a.plan_key == b.plan_key
        assert _rel_l2(a.result(timeout=60),
                       b.result(timeout=60)) <= TOL[precision]


def test_pinned_stockham_replay_is_the_references():
    """A pinned ``stockham_pallas`` replay on two small extents against
    the reference's, whose Pallas kernel runs in interpret mode."""
    spec = TrafficSpec(extents=("16", "12"), requests=8, seed=3)
    with _service(max_batch=4, backend="stockham_pallas") as svc:
        mine = replay(svc, spec, wait_timeout_s=300)
    with RFFTService(config=RServeConfig(max_batch=4,
                                         backend="stockham_pallas")) as svc:
        ref = rreplay(svc, RTrafficSpec.from_dict(spec.to_dict()),
                      wait_timeout_s=300)
    assert mine.service["errors"] == ref.service["errors"] == 0
    for a, b in zip(mine.requests, ref.requests):
        assert a.plan_key == b.plan_key
        assert _rel_l2(a.result(timeout=60), b.result(timeout=60)) <= 1e-5


# ---------------------------------------------------------------------------
# TorchServeFFT through the ordinary suite
# ---------------------------------------------------------------------------
def test_serve_client_through_run_suite():
    spec = SuiteSpec(clients=("TorchServeFFT",), extents=((64,),),
                     kinds=("Outplace_Complex", "Outplace_Real"),
                     precisions=("float",), warmups=0, repetitions=2,
                     output=None)
    rs = _session(serve_burst=3).run(spec)
    assert rs.n_failures == 0
    ops = {r.op for r in rs.rows}
    assert "execute_forward" in ops and "init_inverse" not in ops
    wide = rs.aggregate(op="execute_forward", percentiles=True)
    assert len(wide[0]) == 12                 # percentile columns present
    named = rs.aggregate_named(op="execute_forward", percentiles=True)
    assert named[0].p50 <= named[0].p99


def test_serve_schedule_is_the_references():
    mine, ref = serve_fft.SERVE_SCHEDULE, rserve_fft.SERVE_SCHEDULE
    assert mine.op_names == ref.op_names
    assert [(s.name, s.method, s.needs_input, s.captures_output,
             s.bytes_method) for s in mine.steps] == \
        [(s.name, s.method, s.needs_input, s.captures_output,
          s.bytes_method) for s in ref.steps]
    assert serve_fft.TorchServeFFT.title == "TorchServeFFT"
    p = Problem((64,), "Outplace_Complex", "float", batch=3)
    for client in (serve_fft.TorchServeFFT(p, TorchContext("cpu")),):
        assert client.get_alloc_size() == 2 * 32 * p.signal_bytes // 3
        assert client.get_transfer_size() == 8 * p.signal_bytes
    with pytest.raises(ValueError, match="out-of-place"):
        serve_fft.TorchServeFFT(Problem((64,), "Inplace_Complex"),
                                TorchContext("cpu"))


# ---------------------------------------------------------------------------
# concurrency hammers: shared PlanCache + wisdom store
# ---------------------------------------------------------------------------
def _hammer(n_threads, fn):
    errors = []
    barrier = threading.Barrier(n_threads)

    def work(i):
        try:
            barrier.wait(timeout=30)
            fn(i)
        except Exception as e:             # surface, don't swallow
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)


def test_plan_cache_hammer_single_flight_invariants():
    cache = PlanCache()
    keys = [("exec", k) for k in range(4)]
    builds = []
    build_lock = threading.Lock()
    n_threads, per_thread = 8, 20

    def work(i):
        rng = np.random.default_rng(i)
        for _ in range(per_thread):
            key = keys[int(rng.integers(len(keys)))]

            def build():
                with build_lock:
                    builds.append(key)
                time.sleep(0.001)          # widen the race window
                return object()

            obj, _, _ = cache.executable(key, build)
            assert obj is not None

    _hammer(n_threads, work)
    # single-flight: each key built exactly once, no lost updates
    assert len(builds) == len(keys)
    assert set(builds) == set(keys)
    stats = cache.stats
    assert stats.misses == len(keys)
    assert stats.hits + stats.misses == n_threads * per_thread
    assert len(cache) == len(keys)


def test_plan_cache_hammer_plan_lookups():
    cache = PlanCache()
    problem = Problem((64,), "Outplace_Complex", "float")
    built = []

    def make():
        built.append(1)
        time.sleep(0.001)
        return Plan(problem, Candidate("xla"), PlanRigor.ESTIMATE, 0.0)

    plans = []

    def work(i):
        plan, _ = cache.plan(("plan", "k"), make)
        plans.append(plan)

    _hammer(8, work)
    assert len(built) == 1                 # one builder, 7 waiters
    assert all(p is plans[0] for p in plans)


def test_wisdom_hammer_concurrent_record_and_save(tmp_path):
    path = tmp_path / "wisdom.json"
    w = Wisdom(str(path), device_kind="cpu")
    n_threads = 6

    def work(i):
        for j in range(10):
            p = Problem((64 * (i + 1),), "Outplace_Complex", "float",
                        batch=j % 3 + 1)
            w.record(p, Candidate("xla"))
            w.save()                       # interleaved atomic merges

    _hammer(n_threads, work)
    # the file is valid JSON and a fresh load sees every key
    with open(path) as f:
        json.load(f)
    fresh = Wisdom(str(path), device_kind="cpu")
    for i in range(n_threads):
        for b in (1, 2, 3):
            p = Problem((64 * (i + 1),), "Outplace_Complex", "float", batch=b)
            assert fresh.lookup(p) is not None, p.signature()


def test_service_hammer_many_submitters_one_cache():
    """N producer threads against one service: shared PlanCache misses stay
    bounded by the distinct (plan, bucket) set and every request completes."""
    n_threads, per_thread = 4, 5
    results = {}
    lock = threading.Lock()
    with _service(coalesce_window_ms=1.0, max_batch=8) as svc:
        def work(i):
            for j in range(per_thread):
                x = _payload((32,) if i % 2 else (64,), seed=i * 100 + j)
                out = np.asarray(svc.submit(x).result(timeout=300))
                ref = np.fft.fft(x)
                with lock:
                    results[(i, j)] = np.max(np.abs(out[0] - ref))

        _hammer(n_threads, work)
    assert len(results) == n_threads * per_thread
    assert all(v < 1e-2 for v in results.values())
    rep = svc.report()
    assert rep["completed"] == n_threads * per_thread
    assert rep["errors"] == 0 and rep["timeouts"] == 0
    # 2 plans x pow2 buckets <= 8 -> at most 8 distinct executables
    assert rep["plan_cache"]["misses"] <= 8
