"""Pre-generate FFT planning wisdom over the support matrix (the
reference's ``tools/pregen_wisdom.py``; fftw's ``wisdom`` utility).

Sweeps a grid of problems over the paper's three extent classes, ranks
1-3 and both transform kinds, runs the planner's real measurement sweep
for each (``make_plan(..., near=False)``: a pregeneration run must never
inherit a neighbor's pick) through the planner's own build
(``torch_fft._forward_fn``) on the device, and saves one schema-v3
wisdom pack whose records carry ``measured_ms`` and ``rigor``.  A warm
Session plans every swept problem from the pack, and
``benchmarks/fit_costmodel.py`` reads its ``measured_ms`` rows as
training data beside the grid's BENCH documents.

    PYTHONPATH=src python -m repro_torch.benchmarks.pregen_wisdom \\
        --batch 1024 --out wisdom_h100.json
    PYTHONPATH=src python -m repro_torch.benchmarks.pregen_wisdom \\
        --device cpu --out /tmp/wisdom_cpu.json

Runs on ``cuda:0`` unless ``--device cpu`` asks for the CPU (where every
kernel backend runs its plain version); with no card it raises.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..core.client import Problem, TorchContext
from ..core.clients.torch_fft import _forward_fn
from ..core.extents import classify, parse_extents
from ..core.plan import PlanRigor, make_plan
from ..core.wisdom import Wisdom

#: The reference's support matrix: every paper extent class, ranks 1-3.
DEFAULT_EXTENTS = (
    # rank 1
    "64", "256", "1024", "4096",          # powerof2
    "48", "384", "1080",                  # radix357
    "121", "1001",                        # oddshape (11^2, 7*11*13)
    # rank 2
    "32x32", "64x64",                     # powerof2
    "48x48",                              # radix357
    # rank 3
    "16x16x16",                           # powerof2
)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="pre-generate schema-v3 FFT planning wisdom")
    ap.add_argument("--out", required=True, help="wisdom pack to write")
    ap.add_argument("--extents", nargs="*", default=list(DEFAULT_EXTENTS),
                    help="extent grid (4096 64x64 16x16x16)")
    ap.add_argument("--kinds", nargs="*",
                    default=["Outplace_Complex", "Outplace_Real"])
    ap.add_argument("--precisions", nargs="*", default=["float"])
    ap.add_argument("--batch", type=int, nargs="*", default=[1])
    ap.add_argument("--rigor", choices=["measure", "patient"],
                    default="measure",
                    help="sweep rigor recorded into the pack (measure: "
                         "feasible candidates; patient: + mixed per-axis "
                         "assignments)")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0)")
    args = ap.parse_args(argv)

    rigor = PlanRigor(args.rigor)
    context = TorchContext(args.device)
    context.create()             # raises without the device; builds kernels
    device, device_kind = context.device, context.device_kind
    wisdom = Wisdom(args.out, device_kind=device_kind)

    problems = [Problem(parse_extents(ext), kind, prec, batch=b)
                for ext in args.extents
                for kind in args.kinds
                for prec in args.precisions
                for b in args.batch]
    print(f"sweeping {len(problems)} problems at rigor={rigor.value} "
          f"on {device_kind!r} -> {args.out}")
    t_start = time.perf_counter()
    for i, problem in enumerate(problems):
        t0 = time.perf_counter()
        plan = make_plan(problem, rigor,
                         build=lambda c, p=problem: _forward_fn(p, c, device),
                         wisdom=wisdom, device=device, near=False)
        dt = time.perf_counter() - t0
        best = min(plan.measured_ms.values()) if plan.measured_ms \
            else float("nan")
        print(f"  [{i + 1:3d}/{len(problems)}] "
              f"{problem.signature():<34} {classify(problem.extents):<9} "
              f"-> {plan.candidate.key():<28} best={best:8.3f} ms  "
              f"(swept {dt:6.1f} s)")
    wisdom.save()
    print(f"wrote {len(wisdom)} wisdom entries to {args.out} "
          f"in {time.perf_counter() - t_start:.0f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
