#!/usr/bin/env python3
"""Where the time of one ``execute_forward`` / ``execute_inverse`` goes, on
one GPU, for the port's clients (``src/repro_torch``).

    python3 profile_execute.py [--src DIR] [--problems P1,P4] [--reps 20]

For each problem (the shapes of ``chip_smoke.py``) and client that can take
it it builds the plan once, runs one warm forward/inverse pair, then prints one JSON line
per op:

* ``host_ms``: median host-clock time of the op over ``--reps`` calls (the
  op ends in ``torch.cuda.synchronize``, as in the measurement loop);
* ``device_ms``: device time per call from ``torch.profiler``, the sum of
  the device-side events' times (kernels, copies, sets) over ``--reps``
  further calls, each profiled on its own, divided by ``--reps``;
  ``idle_share`` = 1 - device_ms / host_ms (null when the profiler saw no
  device time);
* ``ops``: the device-side events by time per call, largest first, with
  their launches per call.

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


def measure(client, reps: int) -> list[dict]:
    """Host and device time of each execute op; the ops alternate, since an
    in-place kind's forward gives up the buffer its inverse refills."""
    from torch.profiler import ProfilerActivity, profile

    ops = {"execute_forward": client.execute_forward,
           "execute_inverse": client.execute_inverse}
    for fn in ops.values():
        fn()
    host = {op: [] for op in ops}
    for _ in range(reps):
        for op, fn in ops.items():
            t0 = time.perf_counter()
            fn()
            host[op].append((time.perf_counter() - t0) * 1e3)
    device = {op: {} for op in ops}
    for _ in range(reps):
        for op, fn in ops.items():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
            for avg in prof.key_averages():
                us = _device_us(avg)
                if us > 0:
                    total, count = device[op].get(avg.key, (0.0, 0))
                    device[op][avg.key] = (total + us, count + avg.count)
    rows = []
    for op in ops:
        host_ms = statistics.median(host[op])
        device_ms = sum(us for us, _ in device[op].values()) / reps / 1e3
        top = sorted(device[op].items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
        rows.append({
            "op": op, "host_ms": host_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / host_ms if device_ms > 0 else None,
            "ops": [{"name": key[:120], "ms": us / reps / 1e3,
                     "launches": count / reps}
                    for key, (us, count) in top]})
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(
        description="Device-time breakdown of the port's execute ops")
    parser.add_argument("--src", default=os.path.join(ROOT, "src"),
                        help="the src/ directory holding repro_torch")
    parser.add_argument("--problems", default="P1,P4",
                        help=f"comma-separated, of {','.join(PROBLEMS)}")
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
            for row in measure(client, args.reps):
                print(json.dumps({"label": args.label, "problem": pname,
                                  "client": cname, **row}), flush=True)
            client.destroy()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
