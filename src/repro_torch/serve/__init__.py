"""FFT serving layer on torch: request coalescing, traffic replay, tail
latency.

The offline suite answers "how fast is one FFT on a quiet device"; this
package answers the serving question: what latency distribution does a
*mix* of FFT shapes see under load, and how much does coalescing
same-plan requests into one batched launch buy.

Entry points:

* :class:`FFTService` / :class:`ServeConfig`: the engine (bounded queue,
  coalescer, workers with one CUDA stream each over a shared Session) and
  its fault-tolerance machinery (fallback chains, retries, batch
  bisection, watchdog).
* :class:`TrafficSpec` / :func:`replay`: seeded Zipf mixed-shape traffic
  at a configurable arrival rate.
* :class:`FaultPlan` / :func:`chaos_replay`: deterministic fault injection
  and the graded recovery replay.
* ``repro_torch/benchmarks/table_serve.py`` and ``bench_grid --serve``:
  the reporting surfaces.
"""

from .request import (FFTRequest, QueueFull, RequestTimeout, ServeError,
                      make_request)
from .queue import RequestQueue
from .coalescer import Batch, Coalescer
from .metrics import ServiceMetrics
from .faults import (FaultInjected, FaultPlan, FaultRule, WorkerKilled,
                     faulty_build)
from .engine import FFTService, ServeConfig, WorkerWedged
from .replay import (ChaosReport, ReplayReport, TrafficSpec, chaos_replay,
                     replay)

__all__ = [
    "Batch", "ChaosReport", "Coalescer", "FFTRequest", "FFTService",
    "FaultInjected", "FaultPlan", "FaultRule", "QueueFull", "ReplayReport",
    "RequestQueue", "RequestTimeout", "ServeConfig", "ServeError",
    "ServiceMetrics", "TrafficSpec", "WorkerKilled", "WorkerWedged",
    "chaos_replay", "faulty_build", "make_request", "replay",
]
