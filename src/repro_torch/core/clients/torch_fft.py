"""The torch FFT clients, one per backend "binary" as in the paper:

  xla              ``torch.fft`` (cuFFT on the card): the vendor library,
                   whole-ND, the yardstick (client ``TorchFFT``)
  stockham_pallas  the hand-written fused Stockham kernel for Hopper
                   (``csrc/stockham.cu``), applied per axis through
                   ``nd.fftn``; a real kind's last axis runs the kernel's
                   fold (``ops.rfft`` / ``irfft``, the same kernels of
                   ``csrc/stockham.cu`` / ``stockham64.cu``: the R2C pack
                   in their passes) where one block holds the
                   packed axis, else the packed half-length path around
                   it (client ``TorchStockhamPallas``; knobs: tile_b,
                   radix)
  fourstep_pallas  the hand-written fused four-step kernel
                   (``csrc/fft4step.cu``), per axis like the Stockham
                   kernel (client ``TorchFourStepPallas``; knob: tile_b)
  fft2_pallas      the hand-written fused rank-2 kernel (``csrc/fft2.cu``):
                   the whole 2-D transform in one launch, real kinds of an
                   even last extent through its fold (``ops.rfft2`` /
                   ``irfft2``: the pack in its passes) where one block
                   holds the packed tile, else through
                   ``rfft.rfftn_packed`` (client ``TorchFft2Pallas``;
                   knobs: tile_b, radix); rank 2 only
  dft              the hand-written batched direct DFT kernel
                   (``csrc/dft.cu``) for axes up to 128 points, per axis
                   (knob: tile_b); it has no client of its own, as in the
                   reference: the planner reaches it (ESTIMATE's rank-1
                   pin and per-axis ``nd[...]`` plans)
  sixstep          the six-step composition (``fft/sixstep.py``): the
                   Stockham kernel on the n1 residual, the four-step
                   kernel on n2 <= 16384, transposes and the twiddle
                   multiply in torch; powers of two 4 ... 2^24, per axis
                   (client ``TorchSixStep``; knobs: split_n1, tile_b)
  chirpz_pallas    chirp-Z (``fft/bluestein.py``) with its two padded
                   transforms on the kernels: the Stockham kernel at a
                   7-smooth m <= 2^15, the six-step composition beyond;
                   any n <= 2^23, per axis (client ``TorchChirpZPallas``;
                   knobs: engine, tile_b)
  stockham,        the reference's plain baselines in torch
  fourstep,        (``fft/stockham.py``, ``fft/fourstep.py``, and chirp-Z
  bluestein        on the staged Stockham; clients ``TorchStockham``,
                   ``TorchFourStep``, ``TorchBluestein``)

``TorchPlanned`` is the open planner: its rigor (ESTIMATE, MEASURE,
PATIENT, WISDOM_ONLY) picks the backend, or a per-axis assignment
(``nd[...]``), from every candidate.  The pinned clients take the rigors
too: MEASURE/PATIENT sweep only their own backend's knobs, with wisdom
scoped by the backend.  A plan naming a backend the port lacks (from
wisdom or a key) is a failed node that names it.

A client owns the device buffers and the built transforms of ONE Problem.
``init_forward``/``init_inverse`` are the measured build: for the kernel
backends they compute the twiddle tables (and, for real kinds, the R2C
pack table) on the host and upload them to the device -- for six-step the
n1 Stockham twiddles, the n2 four-step tables and the twiddle grid, for
chirp-Z the chirp, the filter spectrum and the padded engine's tables;
``execute_*`` builds no table.  A problem a kernel cannot take (over its
Hopper cap, the wrong rank) fails in ``init_forward``: the node is
recorded as failed, never handed to another backend.  Without a
PlanCache every run rebuilds (planning stays a measured quantity, paper
Figs. 4/5); with one, the first run pays the build and later runs reuse
it, with hit/miss events surfaced per op.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ...fft import bluestein, fourstep, nd, sixstep, stockham
from ...fft import rfft as rfft_mod
from ...fft.reference import half_roots
from ...kernels.dft_matmul import ops as dft_ops
from ...kernels.fft2_pallas import ops as f2_ops
from ...kernels.fft4step import ops as fs_ops
from ...kernels.stockham_pallas import ops as sp_ops
from ..candidates import (CHIRPZ_PALLAS_MAX_N, Candidate, axis_engine_n,
                          candidates)
from ..client import FFTClient, Problem, TorchContext
from ..plan import (Plan, PlanCache, PlanRigor, cached_build,
                    executable_bytes, make_plan, measure_plan)
from ..registry import register_client
from ..wisdom import Wisdom

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


def _axis_table(cand: Candidate, n: int, inverse: bool, dtype: torch.dtype,
                device):
    """The plan state of one kernel axis of engine length ``n``: Stockham
    twiddles, the four-step kernel's W1/W2/T tables, the DFT matrix, a
    six-step or chirp-Z plan (None for the plain-torch baselines, and for
    a length-1 axis, which the FFT kernels return untouched).  Raises for
    a length over the backend's cap."""
    opts = cand.opts()
    if cand.backend == "dft":
        return dft_ops.make_matrix(n, inverse, dtype, device)
    if n == 1:
        return None
    if cand.backend == "stockham_pallas":
        return sp_ops.make_twiddles(n, opts.get("radix", 8), inverse,
                                    dtype, device)
    if cand.backend == "fourstep_pallas":
        return fs_ops.make_tables(n, inverse, dtype, device)
    if cand.backend == "sixstep":
        return sixstep.make_plan(n, inverse, dtype, device,
                                 opts.get("split_n1"))
    if cand.backend == "chirpz_pallas":
        if n > CHIRPZ_PALLAS_MAX_N:
            raise ValueError(f"chirpz_pallas caps at n={CHIRPZ_PALLAS_MAX_N}"
                             f", as the reference does; got {n}")
        return bluestein.make_plan(n, inverse, dtype, device,
                                   opts.get("engine", "auto"))
    if cand.backend == "bluestein":
        return bluestein.make_plan(n, inverse, dtype, device, "stockham")
    return None


def _engine(cand: Candidate, table) -> Callable:
    """cfft(x, inverse=False) along the LAST axis for one axis of the plan,
    a kernel bound to that axis's prebuilt table.  A backend the port lacks
    raises with its name."""
    opts = cand.opts()
    tile_b = opts.get("tile_b")
    if cand.backend == "stockham_pallas":
        radix = opts.get("radix", 8)
        return lambda x, inverse=False: sp_ops.fft(
            x, inverse, tile_b=tile_b, radix=radix, twiddles=table)
    if cand.backend == "fourstep_pallas":
        return lambda x, inverse=False: fs_ops.fft(x, inverse, tile_b=tile_b,
                                                   twiddles=table)
    if cand.backend == "dft":
        return lambda x, inverse=False: dft_ops.dft(x, inverse, tile_b=tile_b,
                                                    matrix=table)
    if cand.backend == "sixstep":
        n1 = opts.get("split_n1")
        return lambda x, inverse=False: sixstep.fft(
            x, inverse, n1=n1, tile_b=tile_b, plan=table)
    if cand.backend in ("chirpz_pallas", "bluestein"):
        return lambda x, inverse=False: bluestein.fft(
            x, inverse, tile_b=tile_b, plan=table)
    if cand.backend == "stockham":
        return stockham.fft
    if cand.backend == "fourstep":
        return fourstep.fft
    raise ValueError(f"backend {cand.backend!r} of plan {cand.key()} is not "
                     "in the port")


def _axis_engines(problem: Problem, cand: Candidate, inverse: bool,
                  device) -> tuple[list[Callable], list, int]:
    """One engine per axis from the (possibly per-axis) plan, each axis'
    table, and the bytes of the tables; axes with the same backend, knobs
    and engine length share one table."""
    dtype = _complex_dtype(problem)
    tables: dict = {}
    engines, per_axis = [], []
    for axis, c in enumerate(cand.per_axis(problem.rank)):
        n = axis_engine_n(problem, axis)
        key = (c.key(), n)
        if key not in tables:
            tables[key] = _axis_table(c, n, inverse, dtype, device)
        engines.append(_engine(c, tables[key]))
        per_axis.append(tables[key])
    return engines, per_axis, _bytes(*tables.values())


def _stockham_fold(problem: Problem, cand: Candidate, table, roots,
                   inverse: bool, device) -> tuple[Callable | None, int]:
    """A real kind's last-axis fold on the Stockham kernel (``ops.rfft`` /
    ``ops.irfft`` bound to the axis' table and the pack table) where the
    plan runs that axis on ``stockham_pallas`` and one block holds its
    packed length, with the bytes of a table it adds (a one-point packed
    axis has none in the plan); else (None, 0): the axis runs ``rfft.py``
    around its engine."""
    last = cand.per_axis(problem.rank)[-1]
    n = problem.extents[-1]
    m = axis_engine_n(problem, problem.rank - 1)
    dtype = _complex_dtype(problem)
    if last.backend != "stockham_pallas" or m > sp_ops.ONE_BLOCK_N[dtype]:
        return None, 0
    opts = last.opts()
    tile_b, radix = opts.get("tile_b"), opts.get("radix", 8)
    added = 0
    if table is None and n > 1:
        table = sp_ops.make_twiddles(m, radix, inverse, dtype, device)
        added = table.nbytes
    if inverse:
        return (lambda y, n: sp_ops.irfft(y, n, tile_b=tile_b, radix=radix,
                                          twiddles=table, roots=roots)), added
    return (lambda x: sp_ops.rfft(x, tile_b=tile_b, radix=radix,
                                  twiddles=table, roots=roots)), added


def _fft2_fold(problem: Problem, cand: Candidate, twiddles, roots,
               inverse: bool, device) -> tuple[Callable | None, int]:
    """A real kind's fold on the fused rank-2 kernel (``ops.rfft2`` /
    ``ops.irfft2``) where the last extent is even and one block holds the
    packed n1 x n2/2 tile, with the bytes of a table it adds; else (None,
    0): ``rfft.rfftn_packed`` around the kernel."""
    n1, n2 = problem.extents
    dtype = _complex_dtype(problem)
    if n2 % 2 or n1 * (n2 // 2) > f2_ops.ONE_BLOCK_ELEMS[dtype]:
        return None, 0
    opts = cand.opts()
    tile_b, radix = opts.get("tile_b"), opts.get("radix", 8)
    added = 0
    if twiddles is None:   # the one-point packed tile
        twiddles = f2_ops.make_twiddles2(1, 1, radix, inverse, dtype, device)
        added = twiddles.nbytes
    if inverse:
        return (lambda y: f2_ops.irfft2(y, n2, tile_b=tile_b, radix=radix,
                                        twiddles=twiddles, roots=roots)), added
    return (lambda x: f2_ops.rfft2(x, tile_b=tile_b, radix=radix,
                                   twiddles=twiddles, roots=roots)), added


def _fft2_twiddles(problem: Problem, cand: Candidate, inverse: bool,
                   device) -> f2_ops.Twiddles2 | f2_ops.Passes2 | None:
    """The fused rank-2 kernel's plan for the problem's engine tile (the
    packed n1 x n2/2 one for a real kind); raises for another rank or a
    tile over the kernel's cap."""
    if problem.rank != 2:
        raise ValueError(
            f"fft2_pallas is rank-2 only, got rank {problem.rank}")
    n1, n2 = problem.extents[0], axis_engine_n(problem, 1)
    if n1 * n2 == 1:
        return None
    return f2_ops.make_twiddles2(n1, n2, cand.opts().get("radix", 8), inverse,
                                 _complex_dtype(problem), device)


def _fft2_engine(cand: Candidate,
                 twiddles: f2_ops.Twiddles2 | f2_ops.Passes2 | None
                 ) -> Callable:
    """Whole-transform engine cfft2(x, inverse=False) over the LAST TWO
    axes: the fused rank-2 kernel, bound to its prebuilt twiddles."""
    opts = cand.opts()
    tile_b, radix = opts.get("tile_b"), opts.get("radix", 8)
    return lambda x, inverse=False: f2_ops.fft2(x, inverse, tile_b=tile_b,
                                                radix=radix,
                                                twiddles=twiddles)


def _bytes(*tables, roots: torch.Tensor | None = None) -> int:
    return sum(t.nbytes for t in tables if t is not None) + (
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
    if cand.backend == "fft2_pallas":
        tw = _fft2_twiddles(problem, cand, False, device)
        eng2 = _fft2_engine(cand, tw)
        if problem.complex_input:
            return Transform(eng2, _bytes(tw))
        roots = _pack_roots(problem, False, device)
        fold, added = _fft2_fold(problem, cand, tw, roots, False, device)
        if fold is not None:
            return Transform(fold, _bytes(tw, roots=roots) + added)
        return Transform(lambda x: rfft_mod.rfftn_packed(x, eng2, 2, roots),
                         _bytes(tw, roots=roots))
    engines, tables, nbytes = _axis_engines(problem, cand, False, device)
    if problem.complex_input:
        return Transform(lambda x: nd.fftn(x, engines, axes=axes), nbytes)
    roots = _pack_roots(problem, False, device)
    fold, added = _stockham_fold(problem, cand, tables[-1], roots, False,
                                 device)
    return Transform(lambda x: nd.rfftn(x, engines, axes=axes, roots=roots,
                                        r2c=fold),
                     nbytes + _bytes(roots=roots) + added)


def _inverse_fn(problem: Problem, cand: Candidate, device) -> Transform:
    axes = tuple(range(-problem.rank, 0))
    if cand.backend == "xla":
        if problem.complex_input:
            return Transform(lambda y: torch.fft.ifftn(y, dim=axes))
        return Transform(lambda y: torch.fft.irfftn(y, s=problem.extents,
                                                    dim=axes))
    if cand.backend == "fft2_pallas":
        tw = _fft2_twiddles(problem, cand, True, device)
        eng2 = _fft2_engine(cand, tw)
        if problem.complex_input:
            return Transform(lambda y: eng2(y, inverse=True), _bytes(tw))
        roots = _pack_roots(problem, True, device)
        fold, added = _fft2_fold(problem, cand, tw, roots, True, device)
        if fold is not None:
            return Transform(fold, _bytes(tw, roots=roots) + added)
        return Transform(lambda y: rfft_mod.irfftn_packed(
            y, problem.extents, eng2, roots), _bytes(tw, roots=roots))
    engines, tables, nbytes = _axis_engines(problem, cand, True, device)
    if problem.complex_input:
        return Transform(lambda y: nd.fftn(y, engines, axes=axes,
                                           inverse=True), nbytes)
    roots = _pack_roots(problem, True, device)
    fold, added = _stockham_fold(problem, cand, tables[-1], roots, True,
                                 device)
    return Transform(lambda y: nd.irfftn(y, problem.extents, engines,
                                         axes=axes, roots=roots, c2r=fold),
                     nbytes + _bytes(roots=roots) + added)


class TorchFFTClient(FFTClient):
    """Generic client; subclasses pin ``backend_filter`` to mimic having one
    binary per library (gearshifft_cufft, gearshifft_fftw, ...)."""

    title = "torchfft"
    backend_filter: str | None = "xla"   # None: the open planner
    rigor = PlanRigor.ESTIMATE

    def __init__(self, problem: Problem, context: TorchContext,
                 rigor: PlanRigor | None = None, wisdom: Wisdom | None = None,
                 plan_cache: PlanCache | None = None):
        super().__init__(problem, context)
        if rigor is not None:
            self.rigor = rigor
        self.wisdom = wisdom
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
        """Bytes of the device twiddle, DFT and pack tables the plan
        holds."""
        return self._plan_bytes

    # --- planning ---------------------------------------------------------
    def _device_kind(self) -> str:
        return getattr(self.context, "device_kind", "?")

    def _make_plan(self) -> Plan | None:
        """The open planner (``backend_filter`` None) plans with every
        rigor over every candidate.  A client pinned to one backend
        searches only that backend's knobs, with wisdom scoped by the
        backend, as in the reference."""
        build = lambda c: _forward_fn(self.problem, c, self.device)
        if self.backend_filter is None:
            return make_plan(self.problem, self.rigor, build=build,
                             wisdom=self.wisdom, device=self.device)
        t0 = time.perf_counter()
        ms = lambda: (time.perf_counter() - t0) * 1e3
        measured = self.rigor in (PlanRigor.MEASURE, PlanRigor.PATIENT)
        if (measured or self.rigor is PlanRigor.WISDOM_ONLY) \
                and self.wisdom is not None:
            cand = self.wisdom.lookup(self.problem, scope=self.backend_filter)
            if cand is not None and cand.backend == self.backend_filter:
                return Plan(self.problem, cand, self.rigor, ms(),
                            source="wisdom")
        if self.rigor is PlanRigor.WISDOM_ONLY:
            return None   # fftw NULL plan: no persisted selection, no sweep
        cands = [c for c in candidates(
            self.problem, patient=(self.rigor is PlanRigor.PATIENT))
            if c.backend == self.backend_filter] \
            or [Candidate(self.backend_filter)]
        if measured and len(cands) > 1:
            cand, timings = measure_plan(self.problem, build, cands,
                                         self.device)
            if self.wisdom is not None:   # persist the tuned knobs
                self.wisdom.record(self.problem, cand,
                                   scope=self.backend_filter,
                                   measured_ms=timings.get(cand.key()),
                                   rigor=self.rigor.value)
        else:
            cand, timings = cands[0], {}
        return Plan(self.problem, cand, self.rigor, ms(), timings,
                    source=self.rigor.value if timings else "estimate")

    def _select(self) -> Candidate | None:
        if self.plan_cache is not None:
            # memoized selection: a MEASURE/PATIENT sweep runs at most once
            # per problem and scope
            pkey = PlanCache.plan_key(self._device_kind(), self.problem,
                                      self.rigor,
                                      scope=self.backend_filter or "*")
            plan, _ = self.plan_cache.plan(pkey, self._make_plan)
        else:
            plan = self._make_plan()
        if plan is None:
            return None
        self.plan = plan
        return plan.candidate

    @property
    def plan_source(self) -> str:
        """Where this client's plan came from (``Plan.source``): the result
        rows' ``plan_source`` column when wisdom is attached."""
        return self.plan.source if self.plan is not None else ""

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
        if cand is None:
            raise RuntimeError("NULL plan (wisdom miss)")  # fftw semantics
        self._fwd = self._build("init_forward", "forward", cand, _forward_fn)
        self._plan_bytes = executable_bytes(self._fwd)

    def init_inverse(self) -> None:
        cand = self.plan.candidate
        self._inv = self._build("init_inverse", "inverse", cand, _inverse_fn)
        self._plan_bytes += executable_bytes(self._inv)

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


@register_client()
class TorchFourStepPallas(TorchFFTClient):
    title = "TorchFourStepPallas"
    backend_filter = "fourstep_pallas"


@register_client()
class TorchFft2Pallas(TorchFFTClient):
    title = "TorchFft2Pallas"
    backend_filter = "fft2_pallas"


@register_client()
class TorchStockham(TorchFFTClient):
    title = "TorchStockham"
    backend_filter = "stockham"


@register_client()
class TorchFourStep(TorchFFTClient):
    title = "TorchFourStep"
    backend_filter = "fourstep"


@register_client()
class TorchSixStep(TorchFFTClient):
    title = "TorchSixStep"
    backend_filter = "sixstep"


@register_client()
class TorchChirpZPallas(TorchFFTClient):
    title = "TorchChirpZPallas"
    backend_filter = "chirpz_pallas"


@register_client()
class TorchBluestein(TorchFFTClient):
    title = "TorchBluestein"
    backend_filter = "bluestein"


@register_client()
class TorchPlanned(TorchFFTClient):
    """Planner-driven client: the rigor decides the backend, fftw-style."""
    title = "TorchPlanned"
    backend_filter = None
