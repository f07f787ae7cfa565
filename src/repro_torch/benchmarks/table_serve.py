"""Serving table (beyond the paper): tail latency and coalescing gain of
the FFT service under mixed-shape Zipf traffic, on the port.

Three sections, as in the reference package:

* ``serve_replay/*``: a seeded Zipf mix replayed open-loop; per-entry and
  aggregate p50/p95/p99 enqueue-to-complete latency.
* ``serve_burst/*``: a same-shape closed-loop burst, coalesced against the
  serial FIFO baseline (window 0, max_batch 1); ``speedup`` is the
  throughput ratio the coalescer buys.
* ``serve_suite/*``: the ``TorchServeFFT`` client through the ordinary
  Table-1 timed path.
"""

from __future__ import annotations

import time

import numpy as np

from ..core.client import TorchContext
from ..core.suite import Session, SuiteSpec
from ..serve import FFTService, ServeConfig, TrafficSpec, replay
from .common import emit

REPLAY = TrafficSpec(extents=((1024,), (4096,), (256,), (64, 64)),
                     kinds=("Outplace_Complex", "Outplace_Real"),
                     precisions=("float",), requests=96, rate_hz=300.0,
                     zipf_s=1.1, seed=2017)


def _service(config: ServeConfig, device) -> FFTService:
    """A service on ``device``; with none, ``FFTService``'s own default
    session (``cuda:0``)."""
    if device is None:
        return FFTService(config=config)
    return FFTService(Session(TorchContext(device)), config=config)


def _burst(config: ServeConfig, n_requests: int, payload: np.ndarray,
           device=None) -> dict:
    """Closed-loop same-shape burst; returns the service report."""
    with _service(config, device) as svc:
        # pay the bucket ladder's builds outside the measured window
        svc.prewarm(payload.shape)
        t0 = time.perf_counter()
        reqs = svc.submit_many([payload] * n_requests)
        for r in reqs:
            r.result(timeout=600)
        wall = time.perf_counter() - t0
    rep = svc.report()
    rep["burst_wall_s"] = wall
    rep["burst_rps"] = n_requests / wall
    return rep


def run(requests: int = 96, burst: int = 128,
        session: Session | None = None) -> None:
    """The three sections on the session's device (``cuda:0`` unless a
    session is given)."""
    device = session.context.device if session is not None else None
    # --- Zipf mixed-shape replay ------------------------------------------
    spec = REPLAY if requests == REPLAY.requests \
        else TrafficSpec(**{**REPLAY.to_dict(), "requests": requests})
    with _service(ServeConfig(coalesce_window_ms=2.0, max_batch=16),
                  device) as svc:
        for ext, kind, prec in spec.mix():
            svc.prewarm(ext, kind, prec)
        rep = replay(svc, spec)
    svc_rep = rep.service
    lat = svc_rep.get("latency_ms", {})
    emit("serve_replay/p50", lat.get("p50", 0.0) * 1e3,
         f"p95={lat.get('p95', 0.0):.1f}ms p99={lat.get('p99', 0.0):.1f}ms")
    emit("serve_replay/rps", svc_rep["rps"],
         f"coalesce_rate={svc_rep['coalesce_rate']:.2f} "
         f"batches={svc_rep['batches']}/{svc_rep['completed']}")
    for m in rep.per_mix:
        l = m.get("latency_ms", {})
        emit(f"serve_replay/{m['extents']}/{m['kind']}",
             l.get("p50", 0.0) * 1e3,
             f"n={m['requests']} p99={l.get('p99', 0.0):.1f}ms")

    # --- coalesced vs serial same-shape burst ------------------------------
    x = ((np.arange(4096) % 512) / 512.0).astype(np.complex64)
    serial = _burst(ServeConfig(coalesce_window_ms=0.0, max_batch=1,
                                inflight=1, backend="xla"), burst, x, device)
    coalesced = _burst(ServeConfig(coalesce_window_ms=5.0, max_batch=32,
                                   backend="xla"), burst, x, device)
    speedup = coalesced["burst_rps"] / serial["burst_rps"]
    emit("serve_burst/serial", serial["burst_wall_s"] * 1e6,
         f"rps={serial['burst_rps']:.0f}")
    emit("serve_burst/coalesced", coalesced["burst_wall_s"] * 1e6,
         f"rps={coalesced['burst_rps']:.0f} speedup={speedup:.1f}x "
         f"batches={coalesced['batches']}")

    # --- TorchServeFFT through the ordinary suite ---------------------------
    suite = SuiteSpec(clients=("TorchServeFFT",), extents=((1024,),),
                      kinds=("Outplace_Complex",), precisions=("float",),
                      warmups=1, repetitions=3, output=None)
    rs = Session(context=TorchContext(device, {"serve_burst": 8})).run(suite)
    for a in rs.aggregate_named(op="execute_forward", percentiles=True):
        emit(f"serve_suite/{a.library}/{a.extents}", a.mean * 1e3,
             f"p50={a.p50*1e3:.0f}us p99={a.p99*1e3:.0f}us n={a.n}")
