"""Distributed-FFT clients: the mesh-parallel transforms
(``fft/distributed.py``) through the same Table-1 timed path as the
single-device clients, the suite's FFTW-MPI / cuFFTMp "binaries"; the
reference package's ``core/clients/dist_fft.py``.

``TorchDistFFT1D`` runs the distributed four-step; ``TorchDistFFTND``
runs the planned slab or pencil decomposition, choosing among them (and
their local engines) with the distributed cost model, or by timing them
under MEASURE and PATIENT, with wisdom under the scope ``dist``.

The forward emits the FFTW_MPI_TRANSPOSED_OUT layout and the inverse
consumes it, so the round trip has no reordering pass; the context option
``dist_natural=True`` buys natural-order spectra for one more all_to_all
per direction.  ``dist_backend`` ('slab' or 'pencil') forces the ND
decomposition.

Every process of the default group runs the same suite (SPMD) and holds
its own block, on ``cuda:<local rank>`` or on the CPU when the context
says so; with no default group, a one-rank group is started on the
context's device (``launch.mesh.flat_mesh``) and the collectives run at
P = 1, the same code path as P > 1.  Upload cuts the rank's block out of
the host array; download gathers the blocks, so every rank validates the
whole round trip.  A MEASURE pick is collective: every rank times every
candidate, the times are combined with an all_reduce(MAX), and every rank
takes the same minimum (ranks that picked apart would deadlock in the next
all_to_all).  Only rank 0 writes the wisdom file (``Session.run``).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ...fft import distributed as dfft
from ...launch.mesh import default_rank_device, flat_mesh, \
    get_active_mesh, rank_device, reshaped_mesh
from ..candidates import (Candidate, _dist_candidates, dist_local_lengths,
                          dist_supports)
from ..client import FFTClient, Problem, TorchContext
from ..costmodel import dist_local_engine, estimate_bytes_moved
from ..plan import (Plan, PlanCache, PlanRigor, cached_build,
                    executable_bytes, measure_plan)
from ..registry import register_client
from ..wisdom import Wisdom
from .torch_fft import (_TORCH_DTYPES, Transform, _axis_table, _bytes,
                        _complex_dtype, _engine)


def dist_engines(problem: Problem, cand: Candidate, inverse: bool = False,
                 device=None) -> tuple[list, int]:
    """One local engine per sub-transform of a distributed candidate (the
    ``local`` knob where the sweep forced one, else the cost model's best
    separable backend at each local length), each bound to its table for
    ``inverse`` on ``device`` (default: this rank's card; raises without
    one); with the bytes of the tables.  Equal (backend, length) pairs
    share one table."""
    device = default_rank_device(device)
    forced = cand.opts().get("local")
    dtype = _complex_dtype(problem)
    tables: dict = {}
    engines = []
    for n, _ in dist_local_lengths(problem, cand):
        c = Candidate(forced or dist_local_engine(n))
        if (c.backend, n) not in tables:
            tables[(c.backend, n)] = _axis_table(c, n, inverse, dtype,
                                                 device)
        engines.append(_engine(c, tables[(c.backend, n)]))
    return engines, _bytes(*tables.values())


class _DistClient(FFTClient):
    """Buffers and transfers of one rank's block."""

    def __init__(self, problem: Problem, context: TorchContext):
        super().__init__(problem, context)
        self.device = rank_device(context.device)
        self.cache_events: dict[str, str] = {}
        self._natural = bool(context.options.get("dist_natural", False))
        self._mesh = None
        self._in_spec = None
        self._buf = self._spec = None
        self._fwd = self._inv = None
        self._plan_bytes = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _global_shape(self) -> tuple[int, ...]:
        raise NotImplementedError

    def _alloc_block(self) -> None:
        block = dfft.block_shape(self._global_shape(), self._mesh,
                                 self._in_spec)
        self._buf = torch.zeros(block,
                                dtype=_TORCH_DTYPES[self.problem.input_dtype],
                                device=self.device)
        self._sync()

    def destroy(self) -> None:
        self._buf = self._spec = None
        self._fwd = self._inv = None

    def get_alloc_size(self) -> int:
        return 2 * self.problem.signal_bytes   # signal + spectrum buffers

    def get_plan_size(self) -> int:
        return self._plan_bytes

    def execute_forward(self) -> None:
        self._spec = self._fwd(self._buf)
        self._sync()

    def execute_inverse(self) -> None:
        self._buf = self._inv(self._spec)
        self._sync()

    def upload(self, host_data: np.ndarray) -> None:
        x = np.asarray(host_data).reshape(self._global_shape())
        self._buf.copy_(torch.from_numpy(
            np.ascontiguousarray(dfft.shard(x, self._mesh, self._in_spec))))
        self._sync()

    def download(self) -> np.ndarray:
        return dfft.unshard(self._buf, self._mesh,
                            self._in_spec).cpu().numpy()


@register_client()
class TorchDistFFT1D(_DistClient):
    """1-D distributed four-step FFT over every rank of the default group.

    Constraints (failed nodes, not suite aborts): rank-1 complex
    transforms, batch 1, and an n = n1*n2 with the rank count dividing
    both."""

    title = "TorchDistFFT1D"

    def __init__(self, problem: Problem, context: TorchContext,
                 rigor: PlanRigor | None = None, wisdom: Wisdom | None = None,
                 plan_cache: PlanCache | None = None):
        super().__init__(problem, context)
        if problem.rank != 1:
            raise ValueError("DistFFT1D supports rank-1 transforms only")
        if not problem.complex_input:
            raise ValueError("DistFFT1D supports complex kinds only")
        if problem.batch != 1:
            raise ValueError("DistFFT1D supports batch=1 only")
        self.plan_cache = plan_cache
        self._n = problem.extents[0]
        self._in_spec = ("data",)

    def _global_shape(self) -> tuple[int, ...]:
        return (self._n,)

    def allocate(self) -> None:
        self._mesh = flat_mesh(device=self.device)
        self._alloc_block()

    def _compile(self, direction: str, build):
        nat = ",natural" if self._natural else ""
        key = PlanCache.executable_key(
            getattr(self.context, "device_kind", "?"), self.problem,
            f"dist_fourstep[p={self._mesh.size}{nat}]", direction)
        return cached_build(self.plan_cache, self.cache_events,
                            f"init_{direction}", key, build)

    def _build(self, inverse: bool) -> Transform:
        cand = Candidate("dist1d", mesh=(self._mesh.size,))
        engines, nbytes = dist_engines(self.problem, cand, inverse,
                                       self.device)
        make = dfft.make_ifft1d if inverse else dfft.make_fft1d
        fn, _ = make(self._mesh, "data", self._n, natural=self._natural,
                     engines=engines, dtype=_complex_dtype(self.problem),
                     device=self.device)
        self._sync()    # the twiddle build is part of the plan
        return Transform(fn, nbytes + fn.plan_bytes)

    def init_forward(self) -> None:
        self._fwd = self._compile("forward", lambda: self._build(False))
        self._plan_bytes = executable_bytes(self._fwd)

    def init_inverse(self) -> None:
        self._inv = self._compile("inverse", lambda: self._build(True))
        self._plan_bytes += executable_bytes(self._inv)


@register_client()
class TorchDistFFTND(_DistClient):
    """Planned mesh-parallel ND FFT: the slab or pencil decomposition.

    Candidates come from the distributed cost model over the active mesh,
    or a flat mesh over every rank when none is installed; MEASURE and
    PATIENT time the decomposition x local-engine space and record the
    winner in wisdom under the scope ``dist`` with its mesh shape.
    Constraints: rank-2/3 complex kinds whose extents meet the
    decomposition's divisibility."""

    title = "TorchDistFFTND"
    rigor = PlanRigor.ESTIMATE

    def __init__(self, problem: Problem, context: TorchContext,
                 rigor: PlanRigor | None = None, wisdom: Wisdom | None = None,
                 plan_cache: PlanCache | None = None):
        super().__init__(problem, context)
        if problem.rank not in (2, 3):
            raise ValueError("DistFFTND supports rank-2/3 transforms only")
        if not problem.complex_input:
            raise ValueError("DistFFTND supports complex kinds only")
        if rigor is not None:
            self.rigor = rigor
        self.wisdom = wisdom
        self.plan_cache = plan_cache
        self._forced = context.options.get("dist_backend")  # slab | pencil
        self.plan: Plan | None = None
        self._base_mesh = None

    def _global_shape(self) -> tuple[int, ...]:
        return (self.problem.batch, *self.problem.extents)

    # --- planning ---------------------------------------------------------
    def _candidates(self) -> list[Candidate]:
        if self._base_mesh.size < 2:
            # one rank: the collectives still run, on the one-rank group
            return [Candidate("slab", mesh=(1,))]
        patient = self.rigor is PlanRigor.PATIENT
        cands = [c for c in _dist_candidates(self.problem, self._base_mesh,
                                             patient)
                 if c.backend in ("slab", "pencil")]
        if self._forced:
            cands = [c for c in cands if c.backend == self._forced]
        if not cands:
            raise ValueError(
                f"no feasible slab/pencil decomposition of "
                f"{self.problem.extents} over {self._base_mesh.size} devices")
        return cands

    def _measure(self, cands: list[Candidate]
                 ) -> tuple[Candidate, dict[str, float]]:
        """Every rank times every candidate; the slowest rank's time of
        each decides (all_reduce MAX), so every rank takes the same
        pick."""
        def build(c):
            fn, mesh, in_spec, _ = self._build_fn(c, "forward")
            return lambda x: fn(dfft.shard(x, mesh, in_spec).contiguous())

        _, timings = measure_plan(self.problem, build, cands, self.device)
        keys = [c.key() for c in cands]
        t = torch.tensor([timings.get(k, float("nan")) for k in keys],
                         dtype=torch.float64, device=self.device)
        t = torch.nan_to_num(t, nan=float("inf"))
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        ms = t.tolist()
        if min(ms) == float("inf"):
            raise RuntimeError(
                f"no feasible plan for {self.problem.signature()}")
        best = min(range(len(ms)), key=ms.__getitem__)
        return cands[best], {k: (v if v != float("inf") else float("nan"))
                             for k, v in zip(keys, ms)}

    def _make_plan(self) -> Plan:
        t0 = time.perf_counter()
        measured = self.rigor in (PlanRigor.MEASURE, PlanRigor.PATIENT)
        if self.wisdom is not None and \
                self.rigor is not PlanRigor.ESTIMATE:
            cand = self.wisdom.lookup(self.problem, scope="dist")
            if cand is not None and cand.backend in ("slab", "pencil") \
                    and dist_supports(cand.backend, self.problem, cand.mesh) \
                    and _mesh_total(cand.mesh) == self._base_mesh.size:
                return Plan(self.problem, cand, self.rigor,
                            (time.perf_counter() - t0) * 1e3)
        if self.rigor is PlanRigor.WISDOM_ONLY:
            raise RuntimeError("NULL plan (wisdom miss)")
        cands = self._candidates()
        timings: dict[str, float] = {}
        if measured and len(cands) > 1:
            cand, timings = self._measure(cands)
            if self.wisdom is not None:
                self.wisdom.record(self.problem, cand, scope="dist")
        else:
            cand = min(cands,
                       key=lambda c: estimate_bytes_moved(self.problem, c))
        return Plan(self.problem, cand, self.rigor,
                    (time.perf_counter() - t0) * 1e3, timings)

    def _select(self) -> Candidate:
        if self.plan is not None:
            return self.plan.candidate
        if self.plan_cache is not None:
            pkey = PlanCache.plan_key(
                getattr(self.context, "device_kind", "?"), self.problem,
                self.rigor, scope=f"dist[{self._base_mesh.size}]")
            plan, _ = self.plan_cache.plan(pkey, self._make_plan)
        else:
            plan = self._make_plan()
        self.plan = plan
        return plan.candidate

    def _build_fn(self, cand: Candidate, direction: str):
        """The built transform of one candidate and direction, its mesh
        and its block specs (for the MEASURE sweep and the plan's
        build)."""
        mesh = reshaped_mesh(self._base_mesh, cand.mesh)
        inverse = direction == "inverse"
        engines, nbytes = dist_engines(self.problem, cand, inverse,
                                       self.device)
        fn, in_spec, out_spec = self._decompose(cand, mesh, inverse, engines)
        return Transform(fn, nbytes), mesh, in_spec, out_spec

    def _decompose(self, cand: Candidate, mesh, inverse: bool, engines):
        if cand.backend == "slab":
            return dfft.make_slab_fftnd(
                mesh, "d0", self.problem.extents, inverse=inverse,
                natural=self._natural, engines=engines)
        return dfft.make_pencil_fftnd(
            mesh, "d0", "d1", self.problem.extents, inverse=inverse,
            natural=self._natural, engines=engines)

    # --- memory -----------------------------------------------------------
    def allocate(self) -> None:
        active = get_active_mesh()
        self._base_mesh = active if active is not None \
            else flat_mesh(device=self.device)
        cand = self._select()
        self._mesh = reshaped_mesh(self._base_mesh, cand.mesh)
        _, self._in_spec, _ = self._decompose(cand, self._mesh, False, None)
        self._alloc_block()

    # --- planning state ---------------------------------------------------
    def _compile(self, direction: str, build):
        nat = ",natural" if self._natural else ""
        key = PlanCache.executable_key(
            getattr(self.context, "device_kind", "?"), self.problem,
            f"{self.plan.candidate.key()}{nat}", direction)
        return cached_build(self.plan_cache, self.cache_events,
                            f"init_{direction}", key, build)

    def _build(self, direction: str) -> Transform:
        fn = self._build_fn(self.plan.candidate, direction)[0]
        self._sync()    # the engines' tables are part of the plan
        return fn

    def init_forward(self) -> None:
        self._select()
        self._fwd = self._compile("forward", lambda: self._build("forward"))
        self._plan_bytes = executable_bytes(self._fwd)

    def init_inverse(self) -> None:
        self._inv = self._compile("inverse", lambda: self._build("inverse"))
        self._plan_bytes += executable_bytes(self._inv)


def _mesh_total(shape) -> int:
    out = 1
    for s in shape:
        out *= s
    return out
