"""Beyond-paper: the hand-written CUDA kernels against their plain engines,
and the fused fftconv kernel against the unfused ``torch.fft`` path that
motivates it.

Each kernel variant is a registered client behind a minimal op schedule
(allocate -> upload -> execute_forward -> download -> destroy), so the
table is a declarative spec through ``Session.run`` like every other
table.  On a CPU session the kernel clients run their kernels' plain
versions (each wrapper dispatches by the tensor's device).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..core.client import Problem, TorchContext
from ..core.registry import register_client
from ..core.schedule import OpSchedule, OpStep
from ..core.suite import Session, SuiteSpec
from .common import emit, rand_complex, run_suite

#: Direct-call micro-benchmarks: no separate planning/inverse ops.
KERNEL_SCHEDULE = OpSchedule("kernel", (
    OpStep("allocate", "allocate"),
    OpStep("upload", "upload", needs_input=True,
           bytes_method="get_transfer_size"),
    OpStep("execute_forward", "execute_forward"),
    OpStep("download", "download", captures_output=True),
    OpStep("destroy", "destroy"),
))


class KernelClient:
    """One kernel variant behind the minimal schedule; subclasses implement
    ``make_host_input`` and ``_call``."""

    title = "kernel"
    schedule = KERNEL_SCHEDULE

    def __init__(self, problem: Problem, context: TorchContext, rigor=None,
                 wisdom=None, plan_cache=None):
        self.problem = problem
        self.context = context
        self.cache_events: dict[str, str] = {}
        self._args = None
        self._out = None
        self._nbytes = 0

    @classmethod
    def check(cls, problem, host_in, out, error_bound):
        ok = bool(np.all(np.isfinite(np.asarray(out))))
        return ok, "" if ok else "non-finite kernel output"

    def allocate(self) -> None:
        pass

    def destroy(self) -> None:
        self._args = self._out = None

    def get_transfer_size(self) -> int:
        return self._nbytes

    def _sync(self) -> None:
        if self.context.device.type == "cuda":
            torch.cuda.synchronize(self.context.device)

    def upload(self, host_args) -> None:
        self._nbytes = sum(np.asarray(a).nbytes for a in host_args)
        self._args = tuple(torch.from_numpy(np.asarray(a)).to(self.context.device)
                           for a in host_args)
        self._sync()

    def execute_forward(self) -> None:
        self._out = self._call(*self._args)
        self._sync()

    def download(self) -> np.ndarray:
        return self._out.cpu().numpy()

    def _call(self, *args):
        raise NotImplementedError


class _Rows(KernelClient):
    """A batch of complex signals of the problem's extents."""

    @classmethod
    def make_host_input(cls, problem: Problem, seed: int):
        return (rand_complex((problem.batch, *problem.extents), seed=seed),)


@register_client()
class Fft4StepCudaKernel(_Rows):
    title = "KernelFft4StepCuda"

    def _call(self, x):
        from ..kernels.fft4step import ops as fs_ops
        return fs_ops.fft(x)


@register_client()
class FourStepTorchKernel(_Rows):
    title = "KernelFourStepTorch"

    def _call(self, x):
        from ..fft import fourstep
        return fourstep.fft(x)


@register_client()
class StockhamCudaKernel(_Rows):
    title = "KernelStockhamPallasCuda"

    def _call(self, x):
        from ..kernels.stockham_pallas import ops as sp_ops
        return sp_ops.fft(x)


@register_client()
class StockhamTorchKernel(_Rows):
    title = "KernelStockhamTorch"

    def _call(self, x):
        from ..fft import stockham
        return stockham.fft(x)


@register_client()
class Fft2CudaKernel(_Rows):
    """Fused rank-2 kernel: whole n1 x n2 tiles in shared memory, one
    device-memory touch."""
    title = "KernelFft2PallasCuda"

    def _call(self, x):
        from ..kernels.fft2_pallas import ops as f2_ops
        return f2_ops.fft2(x)


@register_client()
class Fft2SeparableKernel(_Rows):
    """The same 2D transform as two 1-D Stockham kernel passes + swapaxes:
    what the planner's separable path pays when fft2_pallas is off."""
    title = "KernelFft2Separable"

    def _call(self, x):
        from ..fft import nd
        from ..kernels.stockham_pallas import ops as sp_ops
        return nd.fftn(x, lambda v, inverse=False: sp_ops.fft(v, inverse),
                       axes=(-2, -1))


class _Fftconv(KernelClient):
    """The fused-vs-unfused fftconv workload: ``channels`` channels of
    ``signals`` signals of the problem's length, ``taps``-tap filters (the
    reference's C, B, K = 4, 4, 64; subclasses set full widths)."""

    channels, signals, taps = 4, 4, 64

    @classmethod
    def conv_inputs(cls, problem: Problem):
        L = problem.extents[0]
        xs = np.random.default_rng(0).standard_normal(
            (cls.channels, cls.signals, L)).astype(np.float32)
        h = np.random.default_rng(1).standard_normal(
            (cls.channels, cls.taps)).astype(np.float32)
        return xs, h


@register_client()
class FftconvFusedKernel(_Fftconv):
    title = "KernelFftconvFused"

    @classmethod
    def make_host_input(cls, problem: Problem, seed: int):
        return cls.conv_inputs(problem)

    def _call(self, xs, h):
        from ..kernels.fftconv import ops as conv_ops
        return conv_ops.fftconv(xs, h)


@register_client()
class FftconvUnfusedKernel(_Fftconv):
    title = "KernelFftconvUnfused"

    @classmethod
    def make_host_input(cls, problem: Problem, seed: int):
        xs, h = cls.conv_inputs(problem)
        c, b, L = xs.shape
        # the same workload in the unfused path's (B, L, D) layout
        xt = np.moveaxis(xs.reshape(c * b, L)[None], -1, 1).reshape(1, L, c * b)
        ht = np.repeat(h, b, axis=0).T
        return (np.ascontiguousarray(xt), np.ascontiguousarray(ht))

    def _call(self, xt, ht):
        from ..fft import fftconv as fftconv_mod
        return fftconv_mod.fftconv(xt, ht, backend="xla")


SPECS = (
    SuiteSpec(clients=("KernelFft4StepCuda", "KernelFourStepTorch",
                       "KernelStockhamPallasCuda", "KernelStockhamTorch"),
              extents=("4096",), batch=8,
              kinds=("Outplace_Complex",), precisions=("float",),
              warmups=2, plan_cache=False, output=None),
    SuiteSpec(clients=("KernelFftconvFused", "KernelFftconvUnfused"),
              extents=("2048",), batch=1,
              kinds=("Outplace_Real",), precisions=("float",),
              warmups=2, plan_cache=False, output=None),
    SuiteSpec(clients=("KernelFft2PallasCuda", "KernelFft2Separable"),
              extents=("64x64",), batch=4,
              kinds=("Outplace_Complex",), precisions=("float",),
              warmups=2, plan_cache=False, output=None),
)

#: client title -> the table row name
NAMES = {
    "KernelFft4StepCuda": "kernel/fft4step_cuda/4096x8",
    "KernelFourStepTorch": "kernel/fourstep_torch/4096x8",
    "KernelStockhamPallasCuda": "kernel/stockham_pallas_cuda/4096x8",
    "KernelStockhamTorch": "kernel/stockham_torch/4096x8",
    "KernelFftconvFused": "kernel/fftconv_fused_cuda/2048",
    "KernelFftconvUnfused": "kernel/fftconv_unfused_xla/2048",
    "KernelFft2PallasCuda": "kernel/fft2_pallas_cuda/64x64x4",
    "KernelFft2Separable": "kernel/fft2_separable_cuda/64x64x4",
}


def run(reps: int = 3, session: Session | None = None) -> None:
    """Every spec through ``Session.run`` (a fresh Session on ``cuda:0``
    unless one is given); one CSV row of mean ``execute_forward`` us per
    client."""
    for spec in SPECS:
        results = run_suite(replace(spec, repetitions=reps), session)
        for a in results.aggregate_named(op="execute_forward"):
            emit(NAMES.get(a.library, f"kernel/{a.library}/{a.extents}"),
                 a.mean * 1e3)
