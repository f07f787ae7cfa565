#!/usr/bin/env python3
"""Where a serving worker's host time goes, on one GPU: the full-size Zipf
replay of ``chip_smoke.py``'s serve phase (S1: ``SERVE_S1``,
``SERVE_S1_CONFIG``) on each backend, with the engine's steps timed.

    python3 profile_serve.py [--backends planned,xla,stockham_pallas]
                             [--bursts N]

For each run it prewarms a fresh service, replays the traffic, and prints
one JSON line with the replay's p50/p99, requests/s, and the worker's
host seconds per step, summed over the replay's batches.  The runs: an
untimed warm-up; the first backend (``planned`` is the planner under
ESTIMATE) with the finiteness probe on the device and on the host
(``np.isfinite`` over the retired output, the reference's probe) in
turns, device, host, host, device; each other backend; the first with
the probe off; and S2 (``table_serve.REPLAY`` at ``SERVE_S2_CONFIG``,
open loop) on the planner; then, with ``--bursts N``, N runs of the
coalesced against serial burst of ``chip_smoke.py`` (``bench_grid``'s
``bench_serve_burst``, ``SERVE_BURST`` requests at 4096), the garbage
collector on and off in turns, each line with the collector's pause
seconds and its full (generation 2) collections during the burst.  The
steps:

* ``plan``: the fallback-chain walk and the plan-cache lookups
  (``_executable``);
* ``stage``: the rows' copy into the pinned input slab (``_stage``);
* ``issue``: the copy in, the transform's launches and the copy out
  issued on the worker's stream (``_issue``);
* ``wait``: the worker blocked on a batch's event (the device and the
  copies still running);
* ``probe``: reading the row flags the device computed beside the
  transform (``_probe``), or the host probe;
* ``deliver``: each request's own copy of its rows (``_deliver``).

It prints the card's name and power limit first and last.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=30).stdout.strip()


def timed_service(host_probe: bool):
    """``FFTService`` with each worker step's host time summed; with
    ``host_probe`` the probe scans the retired output on the host."""
    import numpy as np
    from repro_torch.serve import FFTService

    class Timed(FFTService):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.steps = collections.Counter()

        def _clock(self, step, fn, *args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                self.steps[step] += time.perf_counter() - t0

        def _executable(self, *args):
            return self._clock("plan", super()._executable, *args)

        def _stage(self, *args):
            return self._clock("stage", super()._stage, *args)

        def _issue(self, *args):
            return self._clock("issue", super()._issue, *args)

        def _retire(self, inflight):
            if inflight.event is not None:
                self._clock("wait", inflight.event.synchronize)
            return super()._retire(inflight)

        def _probe(self, inflight, host_out, corrupted):
            if not host_probe:
                return self._clock("probe", super()._probe, inflight,
                                   host_out, corrupted)
            t0 = time.perf_counter()
            finite = np.isfinite(host_out.reshape(len(host_out), -1)).all(1)
            self.steps["probe"] += time.perf_counter() - t0
            return finite

        def _deliver(self, *args):
            return self._clock("deliver", super()._deliver, *args)

    return Timed


def gc_paused(fn, collect: bool, *args) -> dict:
    """``fn(*args)``'s record with the garbage collector on or off, and
    the collector's pause seconds and full collections while it ran."""
    pause = {"s": 0.0, "full": 0, "t0": 0.0}

    def callback(phase, info):
        if phase == "start":
            pause["t0"] = time.perf_counter()
        else:
            pause["s"] += time.perf_counter() - pause["t0"]
            pause["full"] += info["generation"] == 2

    gc.collect()
    gc.callbacks.append(callback)
    if not collect:
        gc.disable()
    try:
        rec = fn(*args)
    finally:
        gc.enable()
        gc.callbacks.remove(callback)
    return {**rec, "gc_pause_s": pause["s"], "gc_full": pause["full"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--backends",
                        default="planned,xla,stockham_pallas,fourstep_pallas")
    parser.add_argument("--bursts", type=int, default=0)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import (SERVE_BURST, SERVE_S1, SERVE_S1_CONFIG,
                            SERVE_S2_CONFIG)
    from repro_torch.benchmarks.bench_grid import bench_serve_burst
    from repro_torch.benchmarks.table_serve import REPLAY
    from repro_torch.core.client import TorchContext
    from repro_torch.core.suite import Session
    from repro_torch.serve import ServeConfig, TrafficSpec, replay

    print(json.dumps({"card": card()}), flush=True)
    s1 = TrafficSpec(**SERVE_S1)
    first, *rest = args.backends.split(",")
    # an untimed warm-up, then the two probes on one backend in turns
    # (device, host, host, device), the other backends, the probe off,
    # and S2
    runs = [("warmup", s1, SERVE_S1_CONFIG, first, "device")]
    runs += [("S1", s1, SERVE_S1_CONFIG, first, p)
             for p in ("device", "host", "host", "device")]
    runs += [("S1", s1, SERVE_S1_CONFIG, b, "device") for b in rest]
    runs += [("S1", s1, SERVE_S1_CONFIG, first, "off"),
             ("S2", REPLAY, SERVE_S2_CONFIG, "planned", "device")]
    for label, spec, config, backend, probe in runs:
        cfg = ServeConfig(backend=None if backend == "planned" else backend,
                          probe_output=probe != "off", **config)
        cls = timed_service(host_probe=probe == "host")
        with cls(Session(TorchContext("cuda:0")), cfg) as svc:
            for ext, kind, prec in spec.mix():
                svc.prewarm(ext, kind, prec)
            svc.steps.clear()
            rep = replay(svc, spec, wait_timeout_s=300)
        s = rep.service
        print(json.dumps({
            "run": label, "backend": backend, "probe": probe,
            "requests": s["completed"], "batches": s["batches"],
            "p50_ms": s["latency_ms"]["p50"], "p99_ms": s["latency_ms"]["p99"],
            "rps": s["rps"], "gib_per_s": s["gib_per_s"],
            "wall_s": rep.wall_s, "steps_s": dict(svc.steps),
            "busy_s": sum(svc.steps.values())}), flush=True)
    for i in range(args.bursts):
        collector = "on" if i % 2 == 0 else "off"
        print(json.dumps({"burst": i, "gc": collector,
                          **gc_paused(bench_serve_burst, collector == "on",
                                      SERVE_BURST, 4096, "cuda:0")}),
              flush=True)
    print(json.dumps({"card": card()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
