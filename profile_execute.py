#!/usr/bin/env python3
"""Where the time of one ``execute_forward`` / ``execute_inverse`` goes, on
one GPU, for the port's clients (``src/repro_torch``), and of one call of
the fused fftconv wrapper.

    python3 profile_execute.py [--src DIR] [--problems P1,P4,F2] [--reps 20]

For each problem (the shapes of ``chip_smoke.py``) and client that can take
it it builds the plan once, runs one warm forward/inverse pair, then prints one JSON line
per op.  For an fftconv width (F2, F3) it profiles the wrapper
``ops.fftconv`` (operands built, then the kernel) and the kernel alone on
prepared operands.  Each line holds:

* ``host_ms``: median host-clock time of the op over ``--reps`` calls (the
  op ends in ``torch.cuda.synchronize``, as in the measurement loop);
* ``device_ms``: device time per call from ``torch.profiler``, the sum of
  the device-side events' times (kernels, copies, sets) over ``--reps``
  further calls, each profiled on its own, divided by ``--reps``;
  ``idle_share`` = 1 - device_ms / host_ms (null when the profiler saw no
  device time);
* ``ops``: the device-side events by time per call, largest first, with
  their launches per call;
* ``host_ops``: the host-side events (aten ops and runtime calls) by self
  host time per call, largest first: what the host does around the
  launches.

``--src`` names the ``src/`` directory that ``repro_torch`` is imported
from, so that two checkouts can be compared with the same script.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: (extents, kind, precision, batch), as in ``chip_smoke.py``.
PROBLEMS = {
    "P1": ((256, 256, 256), "Outplace_Real", "float", 1),
    "P2": ((128, 128, 128), "Inplace_Complex", "double", 1),
    "P3": ((4096,), "Outplace_Complex", "float", 16384),
    "P4": ((3072, 3072), "Outplace_Real", "float", 1),
    "P5": ((945,), "Inplace_Real", "float", 65536),
    "P6": ((128, 128), "Outplace_Real", "float", 8192),
    "P7": ((64, 64), "Inplace_Complex", "double", 8192),
}
#: (channels, signals, L = K) of the fftconv widths, as in ``chip_smoke.py``.
CONV_WIDTHS = {"F2": (768, 32, 2048), "F3": (768, 8, 8192)}
CLIENTS = ("TorchFFT", "TorchStockhamPallas", "TorchFourStepPallas",
           "TorchFft2Pallas")
TOP_OPS = 12


def _device_us(avg) -> float:
    """Device time of a device-side event (a kernel, copy or set), else 0:
    the aten op that launched a kernel reports the same time again as its
    own self device time."""
    from torch.autograd import DeviceType

    if avg.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(avg, name, None)
        if value is not None:
            return float(value)
    return 0.0


def _host_us(avg) -> float:
    """Self host time of a host-side event, else 0."""
    from torch.autograd import DeviceType

    if avg.device_type == DeviceType.CUDA:
        return 0.0
    return float(getattr(avg, "self_cpu_time_total", 0.0) or 0.0)


def measure(ops: dict, reps: int) -> list[dict]:
    """Host and device time of each named op (a callable that ends in a
    synchronize); the ops alternate, since an in-place kind's forward gives
    up the buffer its inverse refills."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in ops.values():
        fn()
    host = {op: [] for op in ops}
    for _ in range(reps):
        for op, fn in ops.items():
            t0 = time.perf_counter()
            fn()
            host[op].append((time.perf_counter() - t0) * 1e3)
    device = {op: {} for op in ops}
    hosted = {op: {} for op in ops}
    for _ in range(reps):
        for op, fn in ops.items():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            for avg in prof.key_averages():
                for table, us in ((device[op], _device_us(avg)),
                                  (hosted[op], _host_us(avg))):
                    if us > 0:
                        total, count = table.get(avg.key, (0.0, 0))
                        table[avg.key] = (total + us, count + avg.count)
    rows = []
    for op in ops:
        host_ms = statistics.median(host[op])
        device_ms = sum(us for us, _ in device[op].values()) / reps / 1e3
        rows.append({
            "op": op, "host_ms": host_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / host_ms if device_ms > 0 else None,
            "ops": _top(device[op], reps), "host_ops": _top(hosted[op], reps)})
    return rows


def _top(table: dict, reps: int) -> list[dict]:
    top = sorted(table.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
    return [{"name": key[:120], "ms": us / reps / 1e3, "launches": count / reps}
            for key, (us, count) in top]


def _synced(fn):
    import torch

    def call():
        fn()
        torch.cuda.synchronize()
    return call


def measure_fftconv(name: str, reps: int) -> list[dict]:
    """The fused fftconv wrapper and its kernel at an fftconv width."""
    import torch
    from repro_torch.kernels.fftconv import ops as conv

    c, b, L = CONV_WIDTHS[name]
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((c, b, L), device="cuda", generator=gen)
    h = torch.randn((c, L), device="cuda", generator=gen) / L ** 0.5
    op = conv.prepare(x, h)
    return measure({"fftconv": _synced(lambda: conv.fftconv(x, h)),
                    "run_kernel": _synced(lambda: conv.run_kernel(op))},
                   reps)


def main() -> int:
    parser = argparse.ArgumentParser(
        description="Device-time breakdown of the port's execute ops")
    parser.add_argument("--src", default=os.path.join(ROOT, "src"),
                        help="the src/ directory holding repro_torch")
    parser.add_argument("--problems", default="P1,P4",
                        help="comma-separated, of "
                             f"{','.join([*PROBLEMS, *CONV_WIDTHS])}")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--label", default="",
                        help="copied into every output line")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_execute: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core.benchmark import make_input
    from repro_torch.core.candidates import backend_supports
    from repro_torch.core.client import Problem, TorchContext
    from repro_torch.core.clients import torch_fft

    context = TorchContext(torch.device("cuda", 0))
    context.create()
    for pname in args.problems.split(","):
        if pname in CONV_WIDTHS:
            for row in measure_fftconv(pname, args.reps):
                print(json.dumps({"label": args.label, "problem": pname,
                                  "client": "fftconv", **row}), flush=True)
            continue
        extents, kind, precision, batch = PROBLEMS[pname]
        problem = Problem(extents, kind, precision, batch)
        for cname in CLIENTS:
            cls = getattr(torch_fft, cname)
            if not backend_supports(cls.backend_filter, problem):
                continue
            client = cls(problem, context)
            client.allocate()
            client.init_forward()
            client.init_inverse()
            client.upload(make_input(problem, seed=1))
            ops = {"execute_forward": client.execute_forward,
                   "execute_inverse": client.execute_inverse}
            for row in measure(ops, args.reps):
                print(json.dumps({"label": args.label, "problem": pname,
                                  "client": cname, **row}), flush=True)
            client.destroy()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
