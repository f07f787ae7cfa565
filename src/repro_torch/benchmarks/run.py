"""Benchmark entry point of the port: one function per table.
Prints ``name,us_per_call,derived`` CSV.

  PYTHONPATH=src python -m repro_torch.benchmarks.run [table ...]

Tables run on ``cuda:0`` (no card: the run fails).  They map to the
paper: overhead=Fig. 2 (the framework's per-op timers against one timer
around the round trip), tts=Fig. 3 (time-to-solution of powerof2 3-D
R2C), plan_rigor=Figs. 4-5 (planning against transform time per rigor),
backends=Fig. 6 (runtime per backend, 1D/2D/3D and the non-power-of-two
classes), radix=Fig. 7 (the extent classes under the vendor path, the
planner and chirp-Z), dtypes=Fig. 8 (R2C against C2C, f32 against f64);
``kernels`` is the beyond-paper kernel table: each hand-written CUDA
kernel against its plain engine, and the fused fftconv kernel against the
unfused ``torch.fft`` path; ``lm_steps`` runs the LM train and decode
steps of four reduced configs through the same runner; ``serve`` is the
beyond-paper serving table
(tail latency under Zipf traffic, coalesced against serial bursts, and
``TorchServeFFT`` through the suite).  Every table is a declarative
:class:`repro_torch.core.suite.SuiteSpec` executed by the shared
``run_suite`` helper.
"""

from __future__ import annotations

import importlib
import sys
import time

TABLES = ["overhead", "tts", "plan_rigor", "backends", "radix", "dtypes",
          "kernels", "lm_steps", "serve"]


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    flags = [a for a in argv if a.startswith("-")]
    want = [a for a in argv if not a.startswith("-")] or TABLES
    # validate up front: a typo'd table must not surface as a bare
    # ImportError halfway through a long run
    unknown = sorted(set(want) - set(TABLES))
    if unknown:
        print(f"unknown table(s): {', '.join(unknown)}\n"
              f"available: {', '.join(TABLES)}", file=sys.stderr)
        return 2
    if flags:
        print(f"warning: ignoring unrecognized flag(s): {' '.join(flags)}",
              file=sys.stderr)
    print("name,us_per_call,derived")
    for name in want:
        mod = importlib.import_module(f"repro_torch.benchmarks.table_{name}")
        t0 = time.perf_counter()
        mod.run()
        print(f"# table_{name} done in {time.perf_counter()-t0:.1f}s",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
