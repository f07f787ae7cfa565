#!/usr/bin/env python3
"""Why a forward after a MEASURE sweep is slower than one after a wisdom
lookup (paper Figs. 4-5, ``table_plan_rigor``), on one GPU.

    python3 profile_plan_rigor.py [--reps 7] [--extents 256,2048,...]

For each extent of ``table_plan_rigor`` (``TorchPlanned``, Inplace_Real
float, batch 1) it pregenerates wisdom as the table does, then runs
``--reps`` client lifecycles (allocate, init_forward, upload) under each
variant and times the forward that follows, as ``run_node`` times
``execute_forward``:

* ``wisdom_only``: init_forward is a wisdom lookup;
* ``measure``: init_forward is the MEASURE sweep (no wisdom attached);
* ``measure+empty_cache`` / ``+gc`` / ``+sleep``: the sweep, then
  ``torch.cuda.empty_cache()``, ``gc.collect()`` or a 200 ms sleep
  before the forward;
* ``measure+warm``: the sweep, then one untimed forward first;
* ``wisdom_only+sweep``: a wisdom lookup after an unrelated sweep of the
  same extent's candidates, on a throwaway input;
* ``wisdom_only+sleep``: a wisdom lookup, then a 200 ms sleep: no sweep,
  only the idle time a sweep leaves before the forward.

Each line holds the medians of ``first_ms`` (the first forward: call and
``torch.cuda.synchronize``), split into ``launch_ms`` (the call returns)
and ``sync_ms`` (the wait), and ``second_ms`` (an identical forward right
after), plus, from one more lifecycle under ``torch.profiler``, the first
forward's device time and its host ops by self time.  It prints the
card's name and power limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
EXTENTS = "256,2048,16x16x16,32x32x32"
TOP_OPS = 10


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip()


def lifecycle(problem, context, rigor, wisdom, after=None, profile=False):
    """One repetition: a fresh client planned under ``rigor``, then the
    timed forward; returns its times (and the profile's tables)."""
    import torch
    from repro_torch.core.benchmark import make_input
    from repro_torch.core.clients.torch_fft import TorchPlanned

    client = TorchPlanned(problem, context, rigor=rigor, wisdom=wisdom)
    client.allocate()
    client.init_forward()
    client.upload(make_input(problem, 2017))
    if after is not None:
        after(client)
    fn, x = client._fwd, client._buf
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile
        prof = tprofile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    fn(x)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    fn(x)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    out = {"first_ms": (t2 - t0) * 1e3, "launch_ms": (t1 - t0) * 1e3,
           "sync_ms": (t2 - t1) * 1e3, "second_ms": (t3 - t2) * 1e3,
           "pick": client.plan.candidate.key()}
    client.destroy()
    if prof is not None:
        out.update(_tables(prof))
    return out


def _tables(prof) -> dict:
    from torch.autograd import DeviceType

    dev, host = {}, {}
    for avg in prof.key_averages():
        if avg.device_type == DeviceType.CUDA:
            us = float(getattr(avg, "self_device_time_total", 0.0)
                       or getattr(avg, "self_cuda_time_total", 0.0) or 0.0)
            if us > 0:
                dev[avg.key[:100]] = us
        else:
            us = float(getattr(avg, "self_cpu_time_total", 0.0) or 0.0)
            if us > 0:
                host[avg.key[:100]] = (us, avg.count)
    top = sorted(host.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
    return {"device_us": sum(dev.values()), "device_ops": dev,
            "host_us": sum(us for us, _ in host.values()),
            "host_ops": [{"name": k, "us": us, "count": c}
                         for k, (us, c) in top]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=7)
    parser.add_argument("--extents", default=EXTENTS)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_plan_rigor: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.client import Problem, TorchContext
    from repro_torch.core.clients.torch_fft import _forward_fn
    from repro_torch.core.extents import parse_extents
    from repro_torch.core.plan import PlanRigor, make_plan
    from repro_torch.core.wisdom import Wisdom

    print(json.dumps({"card": card()}), flush=True)
    context = TorchContext(torch.device("cuda", 0))
    context.create()
    device = context.device
    measure, wonly = PlanRigor.MEASURE, PlanRigor.WISDOM_ONLY

    def sweep(problem):
        make_plan(problem, measure,
                  build=lambda c: _forward_fn(problem, c, device),
                  device=device)

    with tempfile.TemporaryDirectory() as td:
        for spec in args.extents.split(","):
            problem = Problem(parse_extents(spec), "Inplace_Real", "float")
            wisdom = Wisdom(os.path.join(td, f"{spec}.json"),
                            device_kind=context.device_kind)
            make_plan(problem, measure,
                      build=lambda c: _forward_fn(problem, c, device),
                      wisdom=wisdom, device=device, near=False)
            variants = {
                "wisdom_only": (wonly, wisdom, None),
                "measure": (measure, None, None),
                "measure+empty_cache": (
                    measure, None, lambda c: torch.cuda.empty_cache()),
                "measure+gc": (measure, None, lambda c: gc.collect()),
                "measure+sleep": (measure, None,
                                  lambda c: time.sleep(0.2)),
                "measure+warm": (measure, None, lambda c: (
                    c._fwd(c._buf), torch.cuda.synchronize())),
                "wisdom_only+sweep": (wonly, wisdom, None),
                "wisdom_only+sleep": (wonly, wisdom,
                                      lambda c: time.sleep(0.2)),
            }
            for name, (rigor, w, after) in variants.items():
                runs = []
                for _ in range(args.reps):
                    if name == "wisdom_only+sweep":
                        sweep(problem)
                    runs.append(lifecycle(problem, context, rigor, w, after))
                if name == "wisdom_only+sweep":
                    sweep(problem)
                prof = lifecycle(problem, context, rigor, w, after,
                                 profile=True)
                row = {"extents": spec, "variant": name,
                       "picks": sorted({r["pick"] for r in runs}),
                       "reps": args.reps}
                for key in ("first_ms", "launch_ms", "sync_ms", "second_ms"):
                    row[key] = statistics.median(r[key] for r in runs)
                row["first_ms_all"] = [r["first_ms"] for r in runs]
                row["profiled"] = {k: prof[k] for k in
                                   ("first_ms", "device_us", "host_us",
                                    "device_ops", "host_ops")}
                print(json.dumps(row), flush=True)
    print(json.dumps({"card": card()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
