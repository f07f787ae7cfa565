"""TorchServeFFT: the serving engine driven through the Table-1 timed path.

The other clients measure one transform on a quiet device; this one
measures the service: a burst of same-problem requests submitted through
:class:`repro_torch.serve.FFTService`, so the timed ``execute_forward``
covers queueing, coalescing into batched launches, and result scatter.
It lets the suite machinery (SuiteSpec trees, ResultSet aggregation)
benchmark the serving layer with no new harness code.

Schedule (serving has no inverse path: forward only):

    allocate         construct + start the service (threads, streams)
    init_forward     warm the plan: one probe request pays any cold
                     plan/build (hit/miss recorded from the shared cache)
    upload           stage the burst: K copies of the host input
    execute_forward  submit the K-request burst, wait for every result
    download         first result (validation input)
    destroy          drain + stop the service

Context options (all ``serve_``-prefixed, ``TorchContext(options=...)``):
``serve_burst`` (requests per measured burst, default 8),
``serve_window_ms``, ``serve_max_batch``, ``serve_workers``,
``serve_inflight``, ``serve_backend`` (pin one backend).
"""

from __future__ import annotations

import numpy as np

from ..client import FFTClient, Problem, TorchContext
from ..plan import PlanCache, PlanRigor
from ..registry import register_client
from ..schedule import OpSchedule, OpStep
from ..wisdom import Wisdom

#: Table-1 minus the inverse steps: a service serves forward transforms.
SERVE_SCHEDULE = OpSchedule("serve", (
    OpStep("allocate", "allocate", bytes_method="get_alloc_size"),
    OpStep("init_forward", "init_forward", bytes_method="get_plan_size"),
    OpStep("upload", "upload", needs_input=True,
           bytes_method="get_transfer_size"),
    OpStep("execute_forward", "execute_forward"),
    OpStep("download", "download", captures_output=True,
           bytes_method="get_transfer_size"),
    OpStep("destroy", "destroy"),
))


@register_client()
class TorchServeFFT(FFTClient):
    title = "TorchServeFFT"
    schedule = SERVE_SCHEDULE

    def __init__(self, problem: Problem, context: TorchContext,
                 rigor: PlanRigor | None = None, wisdom: Wisdom | None = None,
                 plan_cache: PlanCache | None = None):
        super().__init__(problem, context)
        if problem.inplace:
            # the service scatters results out of a fresh batch buffer;
            # claiming in-place semantics would be a lie
            raise ValueError("TorchServeFFT supports out-of-place kinds only")
        opts = context.options
        self.burst = int(opts.get("serve_burst", 8))
        if self.burst < 1:
            raise ValueError(f"serve_burst must be >= 1, got {self.burst}")
        self.rigor = rigor if rigor is not None else PlanRigor.ESTIMATE
        self.wisdom = wisdom
        self.plan_cache = plan_cache
        self.cache_events: dict[str, str] = {}
        from ...serve import ServeConfig

        self._config = ServeConfig(
            coalesce_window_ms=float(opts.get("serve_window_ms", 2.0)),
            max_batch=max(int(opts.get("serve_max_batch", 32)),
                          problem.batch),
            workers=int(opts.get("serve_workers", 1)),
            inflight=int(opts.get("serve_inflight", 2)),
            rigor=self.rigor.value if isinstance(self.rigor, PlanRigor)
            else str(self.rigor),
            backend=opts.get("serve_backend"),
            record_requests=False)   # the Runner records; don't double-book
        self._service = None
        self._host = None
        self._results: list[np.ndarray] = []

    # --- memory -----------------------------------------------------------
    def allocate(self) -> None:
        from ...serve import FFTService
        from ..suite import Session

        session = Session(context=self.context, plan_cache=self.plan_cache,
                          wisdom=self.wisdom)
        self._service = FFTService(session=session, config=self._config,
                                   wisdom=self.wisdom).start()

    def destroy(self) -> None:
        if self._service is not None:
            self._service.stop()
            self._service = None
        self._host = None
        self._results = []

    def get_alloc_size(self) -> int:
        # staging + device batch buffer at the coalesced bucket size
        per_row = self.problem.signal_bytes // max(self.problem.batch, 1)
        return 2 * self._config.max_batch * per_row

    def get_transfer_size(self) -> int:
        return self.burst * self.problem.signal_bytes

    # --- planning ---------------------------------------------------------
    def init_forward(self) -> None:
        """Warm the plan and its build with one probe request, so the cold
        build is attributed here (like every other client) and the timed
        burst measures steady-state serving."""
        stats = self._service.session.plan_cache.stats
        misses0 = stats.misses
        probe = np.zeros((self.problem.batch, *self.problem.extents),
                         dtype=self.problem.input_dtype)
        req = self._service.submit(probe, kind=self.problem.kind,
                                   precision=self.problem.precision,
                                   rank=self.problem.rank)
        req.result(timeout=600)
        self.cache_events["init_forward"] = (
            "miss" if stats.misses > misses0 else "hit")

    def init_inverse(self) -> None:
        raise NotImplementedError("TorchServeFFT serves forward transforms "
                                  "only")

    # --- execution ---------------------------------------------------------
    def execute_forward(self) -> None:
        reqs = [self._service.submit(self._host, kind=self.problem.kind,
                                     precision=self.problem.precision,
                                     rank=self.problem.rank)
                for _ in range(self.burst)]
        self._results = [np.asarray(r.result(timeout=600)) for r in reqs]

    def execute_inverse(self) -> None:
        raise NotImplementedError("TorchServeFFT serves forward transforms "
                                  "only")

    # --- transfer ----------------------------------------------------------
    def upload(self, host_data: np.ndarray) -> None:
        self._host = np.asarray(host_data).reshape(
            (self.problem.batch, *self.problem.extents))

    def download(self) -> np.ndarray:
        return self._results[0]

    # --- validation ---------------------------------------------------------
    @classmethod
    def check(cls, problem: Problem, host_in: np.ndarray, out: np.ndarray,
              error_bound: float) -> tuple[bool, str]:
        """Forward-only validation against the numpy reference (there is no
        inverse leg to round-trip through)."""
        x = np.asarray(host_in).reshape((problem.batch, *problem.extents))
        axes = tuple(range(-problem.rank, 0))
        if problem.complex_input:
            ref = np.fft.fftn(x.astype(np.complex128), axes=axes)
        else:
            ref = np.fft.rfftn(x.astype(np.float64), axes=axes)
        got = np.asarray(out).reshape(ref.shape).astype(np.complex128)
        scale = float(np.max(np.abs(ref)) or 1.0)
        err = float(np.max(np.abs(got - ref))) / scale
        # float32 transforms accumulate more rounding than the paper's 1e-5
        # roundtrip bound allows for a one-way spectrum comparison
        bound = max(error_bound, 1e-4 if problem.precision == "float"
                    else 1e-10)
        ok = err <= bound
        return ok, "" if ok else f"forward_err={err:.3e} > {bound:g}"
