"""Run one cell of the port's benchmark on this machine's cards.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``.  With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, read from a profiler trace of the
window.  Earlier lines of standard output give the card, its power limit,
the plan the planner picked (and whether it is the one the cell expects)
and the port's launches a pair; the last line is the result:

    {"correct": ..., "attempted": ..., "failed": ..., "metrics": {...},
     "device": {...}, ["breakdown": {...},] "checks": {...}}

``checks`` holds each number compared beside its limit; they are also the
last lines of standard error.  Without a CUDA card, or with fewer than the
cell asks for, the run exits 2 and prints no result; with a module of JAX
or of the JAX package loaded once the window has closed, it exits 3.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import math       # noqa: E402
import os         # noqa: E402
import subprocess  # noqa: E402
import sys        # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: Top-level module names that may not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _setup_paths() -> None:
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    # every cache of the program and of torch at a fixed path in the checkout
    build = ROOT / "build"
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(build / "torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def forbidden_modules() -> list[str]:
    """Loaded top-level module names of JAX or the JAX package, compared
    whole (``repro_torch`` is the port, not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unread ({exc})"
    return out.stdout.strip() or f"unread (exit {out.returncode})"


def _finite(obj):
    """``obj`` with every float that is not finite as null, so that the
    line stays JSON."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    _setup_paths()
    import torch

    from perfbench import harness, loader

    t_torch = time.perf_counter() - T_PROCESS
    cell = loader.cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    t_cuda = time.perf_counter() - T_PROCESS

    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3

    correct, failed, checks = harness.verdict(run)
    names = cell.per_layer if args.trace else cell.end_to_end
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": correct, "attempted": run.pairs, "failed": failed,
              "metrics": harness.metrics(run, names), "device": device}
    if args.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks

    expect = cell.spec["expect_plan"]
    info = {"perfbench": args.workload, "seed": args.seed,
            "card": _power_limit(), "batch": run.problem.batch,
            "plan": run.plan, "expect_plan": expect,
            "launches_per_pair": harness.launches_per_pair(run),
            "setup_phases_s": {"torch_imported": t_torch,
                               "cuda_found": t_cuda, **run.setup_phases},
            "check_s": run.check_s,
            "checked_pairs": run.errors}
    if run.plan != expect:
        info["note"] = f"the planner picked {run.plan}, not {expect}"
    print(json.dumps(_finite(info)), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
