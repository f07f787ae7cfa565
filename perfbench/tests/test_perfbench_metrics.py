"""The metric readers and the trace reader on a synthetic trace."""

from collections import Counter

import _paths
import pytest
from torch.autograd import DeviceType

from perfbench import loader, tracing, yardstick
from perfbench.harness import Run

CELL = loader.cell("pow2-4096-r2c.exec")
PORT = "void (anonymous namespace)::fft4step_fft_kernel<float, 256>(Cx<float> const*, Cx<float>*)"
ADD = "void at::native::vectorized_elementwise_kernel<2, at::native::CUDAFunctor_add<c10::complex<float> > >(int)"
COPY = "Memcpy DtoD (Device -> Device)"


class Ev:
    """A stand-in for one of the profiler's raw events (times in us)."""

    def __init__(self, name, start_us, dur_us, device=False, note=False,
                 cid=0):
        self._v = (name, int(start_us * 1e3), int(dur_us * 1e3),
                   DeviceType.CUDA if device else DeviceType.CPU, note, cid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


def _events():
    """A 1000 us window: two pairs, each a port kernel (300 us) and a torch
    add (100 us), and one copy the harness launched from a snapshot."""
    ev = [Ev(tracing.WINDOW, 0, 1000, note=True)]
    for k, t in enumerate((0, 500)):
        ev += [Ev("execute_forward", t, 450, note=True),
               Ev("cudaLaunchKernel", t + 2, 3, cid=10 + 2 * k),
               Ev(PORT, t + 20, 300, device=True, cid=10 + 2 * k),
               Ev("cudaLaunchKernel", t + 15, 5, cid=11 + 2 * k),
               Ev(ADD, t + 320, 100, device=True, cid=11 + 2 * k),
               Ev("cudaDeviceSynchronize", t + 20, 410),
               Ev("execute_forward", t + 20, 400, device=True, note=True)]
    ev += [Ev(tracing.SNAPSHOT, 455, 40, note=True),
           Ev("cudaMemcpyAsync", 456, 3, cid=99),
           Ev(COPY, 460, 30, device=True, cid=99),
           Ev("harness.launch.outside", 2000, 1, device=True, cid=7)]
    return ev


KERNELS = {"fft4step_fft_kernel": "fft4step"}


def _run(trace=None):
    p = CELL.problem()
    return Run(cell=CELL, problem=p, setup_s=9.5, init_ms=20.0, pairs=2,
               window_s=0.002, pair_s=[0.001, 0.0009],
               launches={"fft4step": 4, "dft_matmul": 0},
               launch_shapes={"fft4step": Counter({(2048, 32768,
                                                    "complex64"): 4})},
               trace=trace)


def test_trace_from_events():
    tr = tracing.from_kineto(_events(), KERNELS)
    assert tr.window_s == pytest.approx(1e-3)
    names = [op.name for op in tr.ops]
    assert names == [PORT, ADD, PORT, ADD]     # the snapshot's copy is out
    assert [op.source for op in tr.ops] == ["fft4step", None] * 2
    assert tr.busy_s == pytest.approx(800e-6)
    # idle: 0-20 us (in execute_forward), 420-520 (mid-point in the
    # snapshot), 920-1000 (in no host event)
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert gaps == pytest.approx({"execute_forward": 20e-6,
                                  tracing.SNAPSHOT: 100e-6,
                                  "harness loop": 80e-6})
    ops = dict(tr.breakdown()["device_ops"])
    assert ops[PORT[:tracing.NAME_CHARS]] == pytest.approx(600e-6)


def test_trace_without_window_raises():
    with pytest.raises(RuntimeError):
        tracing.from_kineto(_events()[1:], KERNELS)


def test_readers_on_the_synthetic_trace():
    run = _run(tracing.from_kineto(_events(), KERNELS))
    read = lambda name: loader.reader(name)(run)
    assert read("exec_pair_ms") == pytest.approx(1.0)
    assert read("exec_pair_p95_ms") == pytest.approx(0.995)
    assert read("setup_s") == 9.5 and read("init_ms") == 20.0
    assert read("exec_mfu") == pytest.approx(
        yardstick.pair_bound_s(run.problem) / 1e-3 * 100)
    assert read("torch_pass_ms") == pytest.approx(0.1)
    assert read("port_launches") == 2.0
    assert read("device_idle") == pytest.approx(20.0)
    bound = 4 * (2 * 2048 * 32768 * 8) / 3.35e12
    assert read("fft4step_roofline") == pytest.approx(bound / 600e-6 * 100)
    assert read("dft_roofline") is None


def test_trace_readers_silent_without_a_trace():
    run = _run()
    for name in ("torch_pass_ms", "device_idle", "fft4step_roofline",
                 "dft_roofline"):
        assert loader.reader(name)(run) is None


def test_port_kernels_read_from_the_sources():
    found = tracing.port_kernels(_paths.ROOT / "src" / "repro_torch" / "csrc")
    assert found["fft4step_fft_kernel"] == "fft4step"
    assert found["dft_chirp_kernel"] == "dft"
    assert found["block_fft"] == "stockham_stages"
    assert "__launch_bounds__" not in found


@pytest.mark.parametrize("name,ident", [
    (PORT, "fft4step_fft_kernel"),
    ("void (anonymous namespace)::dft_chirp_kernel<float, 5, 8>((anonymous "
     "namespace)::Cx<float> const*, (", "dft_chirp_kernel"),
    (ADD, "vectorized_elementwise_kernel"),
    ("_Z16dft_chirp_kernelIfLi5ELi8EEvPK2CxIT_E", "dft_chirp_kernel"),
    (COPY, "DtoD"),
])
def test_kernel_ident(name, ident):
    assert tracing.kernel_ident(name) == ident
