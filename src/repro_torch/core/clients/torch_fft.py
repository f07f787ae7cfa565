"""The torch FFT clients, one per backend "binary" as in the paper:

  xla              ``torch.fft`` (cuFFT on the card): the vendor library,
                   whole-ND, the yardstick (client ``TorchFFT``)
  stockham_pallas  the hand-written fused Stockham kernel for Hopper
                   (``csrc/stockham.cu``), applied per axis through
                   ``nd.fftn``, with the packed half-length path for real
                   kinds (client ``TorchStockhamPallas``; knobs: tile_b,
                   radix)

A client owns the device buffers and the built transforms of ONE Problem.
``init_forward``/``init_inverse`` are the measured build: for the kernel
backend they compute the twiddle tables (and, for real kinds, the R2C pack
table) on the host and upload them to the device; ``execute_*`` builds no
table.  Without a PlanCache every run rebuilds (planning stays a measured
quantity, paper Figs. 4/5); with one, the first run pays the build and
later runs reuse it, with hit/miss events surfaced per op.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ...fft import nd
from ...fft.reference import half_roots
from ...kernels.stockham_pallas import ops as sp_ops
from ..candidates import Candidate, axis_engine_n
from ..client import FFTClient, Problem, TorchContext
from ..plan import Plan, PlanCache, PlanRigor, cached_build, make_plan
from ..registry import register_client

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64,
                 np.dtype(np.complex64): torch.complex64,
                 np.dtype(np.complex128): torch.complex128}


@dataclass(frozen=True)
class Transform:
    """A built transform: ``fn`` plus the device bytes its plan holds."""

    fn: Callable[[torch.Tensor], torch.Tensor]
    plan_bytes: int = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def _complex_dtype(problem: Problem) -> torch.dtype:
    return torch.complex64 if problem.precision == "float" else torch.complex128


def _twiddle_table(problem: Problem, cand: Candidate, inverse: bool,
                   device) -> dict[int, sp_ops.Twiddles]:
    """The Stockham plan of every engine length the problem's axes need."""
    radix = cand.opts().get("radix", 8)
    lengths = {axis_engine_n(problem, i) for i in range(problem.rank)}
    return {n: sp_ops.make_twiddles(n, radix, inverse, _complex_dtype(problem),
                                    device)
            for n in sorted(lengths) if n > 1}


def _engine(cand: Candidate, table: dict[int, sp_ops.Twiddles]) -> Callable:
    """cfft(x, inverse=False) along the LAST axis through the kernel, bound
    to the prebuilt twiddles of each length."""
    if cand.backend != "stockham_pallas":
        raise ValueError(f"unknown backend {cand.backend!r}")
    opts = cand.opts()
    tile_b, radix = opts.get("tile_b"), opts.get("radix", 8)

    def cfft(x, inverse=False):
        n = x.shape[-1]
        return sp_ops.fft(x, inverse, tile_b=tile_b, radix=radix,
                          twiddles=table[n] if n > 1 else None)

    return cfft


def _bytes(table: dict[int, sp_ops.Twiddles],
           roots: torch.Tensor | None = None) -> int:
    return sum(t.nbytes for t in table.values()) + (
        roots.nbytes if roots is not None else 0)


def _pack_roots(problem: Problem, inverse: bool,
                device) -> torch.Tensor | None:
    """The R2C pack/unpack table of a real kind's even last axis (None for
    an odd one, which takes the full complex transform)."""
    n = problem.extents[-1]
    if n % 2:
        return None
    return half_roots(n, inverse, _complex_dtype(problem), device=device)


def _forward_fn(problem: Problem, cand: Candidate, device) -> Transform:
    axes = tuple(range(-problem.rank, 0))
    if cand.backend == "xla":
        if problem.complex_input:
            return Transform(lambda x: torch.fft.fftn(x, dim=axes))
        return Transform(lambda x: torch.fft.rfftn(x, dim=axes))
    table = _twiddle_table(problem, cand, False, device)
    eng = _engine(cand, table)
    if problem.complex_input:
        return Transform(lambda x: nd.fftn(x, eng, axes=axes), _bytes(table))
    roots = _pack_roots(problem, False, device)
    return Transform(lambda x: nd.rfftn(x, eng, axes=axes, roots=roots),
                     _bytes(table, roots))


def _inverse_fn(problem: Problem, cand: Candidate, device) -> Transform:
    axes = tuple(range(-problem.rank, 0))
    if cand.backend == "xla":
        if problem.complex_input:
            return Transform(lambda y: torch.fft.ifftn(y, dim=axes))
        return Transform(lambda y: torch.fft.irfftn(y, s=problem.extents,
                                                    dim=axes))
    table = _twiddle_table(problem, cand, True, device)
    eng = _engine(cand, table)
    if problem.complex_input:
        return Transform(lambda y: nd.fftn(y, eng, axes=axes, inverse=True),
                         _bytes(table))
    roots = _pack_roots(problem, True, device)
    return Transform(lambda y: nd.irfftn(y, problem.extents, eng, axes=axes,
                                         roots=roots),
                     _bytes(table, roots))


class TorchFFTClient(FFTClient):
    """Generic client; subclasses pin ``backend_filter`` to mimic having one
    binary per library (gearshifft_cufft, gearshifft_fftw, ...)."""

    title = "torchfft"
    backend_filter: str = "xla"
    rigor = PlanRigor.ESTIMATE

    def __init__(self, problem: Problem, context: TorchContext,
                 rigor: PlanRigor | None = None,
                 plan_cache: PlanCache | None = None):
        super().__init__(problem, context)
        if rigor is not None:
            self.rigor = rigor
        self.device = context.device
        self.plan_cache = plan_cache
        self.cache_events: dict[str, str] = {}
        self.plan: Plan | None = None
        self._buf = self._spec = None
        self._fwd = self._inv = None
        self._plan_bytes = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- memory -----------------------------------------------------------
    def allocate(self) -> None:
        p = self.problem
        self._buf = torch.zeros((p.batch, *p.extents),
                                dtype=_TORCH_DTYPES[p.input_dtype],
                                device=self.device)
        self._sync()

    def destroy(self) -> None:
        self._buf = self._spec = None
        self._fwd = self._inv = None

    def get_alloc_size(self) -> int:
        n_in = self.problem.signal_bytes
        if self.problem.inplace:
            if self.problem.complex_input:
                return n_in
            # FFTW padded in-place r2c layout: the real array's last axis is
            # padded to 2*(n/2+1) reals so the half spectrum fits in place
            return self._halfspec_bytes()
        if self.problem.complex_input:
            return 2 * n_in
        return n_in + self._halfspec_bytes()

    def _halfspec_bytes(self) -> int:
        ext = self.problem.extents
        n_out = self.problem.batch
        for v in ext[:-1]:
            n_out *= v
        n_out *= ext[-1] // 2 + 1
        return n_out * self.problem.input_dtype.itemsize * (
            2 if not self.problem.complex_input else 1)

    def get_plan_size(self) -> int:
        """Bytes of the device twiddle and pack tables the plan holds."""
        return self._plan_bytes

    # --- planning ---------------------------------------------------------
    def _device_kind(self) -> str:
        return getattr(self.context, "device_kind", "?")

    def _select(self) -> Candidate:
        make = lambda: make_plan(self.problem, self.rigor, self.backend_filter)
        if self.plan_cache is not None:
            pkey = PlanCache.plan_key(self._device_kind(), self.problem,
                                      self.rigor, scope=self.backend_filter)
            self.plan, _ = self.plan_cache.plan(pkey, make)
        else:
            self.plan = make()
        return self.plan.candidate

    def _build(self, op: str, direction: str, cand: Candidate,
               make: Callable) -> Transform:
        key = PlanCache.executable_key(self._device_kind(), self.problem,
                                       cand, direction)

        def build():
            t = make(self.problem, cand, self.device)
            self._sync()    # the twiddle upload is part of the build
            return t

        return cached_build(self.plan_cache, self.cache_events, op, key, build)

    def init_forward(self) -> None:
        cand = self._select()
        self._fwd = self._build("init_forward", "forward", cand, _forward_fn)
        self._plan_bytes = self._fwd.plan_bytes

    def init_inverse(self) -> None:
        cand = self.plan.candidate
        self._inv = self._build("init_inverse", "inverse", cand, _inverse_fn)
        self._plan_bytes += self._inv.plan_bytes

    # --- execution --------------------------------------------------------
    def execute_forward(self) -> None:
        self._spec = self._fwd(self._buf)
        if self.problem.inplace:
            self._buf = None   # the input buffer is given up, as with donation
        self._sync()

    def execute_inverse(self) -> None:
        self._buf = self._inv(self._spec)
        if self.problem.inplace:
            self._spec = None
        self._sync()

    # --- transfer ---------------------------------------------------------
    def upload(self, host_data: np.ndarray) -> None:
        self._buf.copy_(torch.from_numpy(np.ascontiguousarray(host_data)))
        self._sync()

    def download(self) -> np.ndarray:
        return self._buf.cpu().numpy()


# --- one "binary" per library, as in the paper ------------------------------
@register_client()
class TorchFFT(TorchFFTClient):
    title = "TorchFFT"
    backend_filter = "xla"


@register_client()
class TorchStockhamPallas(TorchFFTClient):
    title = "TorchStockhamPallas"
    backend_filter = "stockham_pallas"
