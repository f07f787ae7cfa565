"""Per-backend FFT throughput over a fixed extent grid: the perf
trajectory record, the grid mode of the reference's
``tools/bench_compare.py`` on the port.

Times the forward transform only, built by the planner's own build
(``torch_fft._forward_fn``, what MEASURE times), and writes one schema-2
BENCH document (``core/compare.py``):

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_grid \\
        --batch 1024 --reps 5 --warmups 2 --out BENCH_h100.json \\
        --report fig7_h100.md
    PYTHONPATH=src python -m repro_torch.benchmarks.bench_grid \\
        --device cpu --smoke --out /tmp/b.json

The grid is the reference's: its extents (1-D, 2-D and 3-D, all three
paper extent classes), its backends and its row columns, so a row lines
up with the reference's under ``compare.ALIGN_KEY``.  The backend key
``xla`` is the vendor path, which on the port is ``torch.fft`` (cuFFT on
the card).  ``gib_per_s`` counts one read and one write of the signal;
``model_flops`` (5·N·log2 N), ``model_bytes`` (the active cost model's
bytes) and ``roofline_frac`` (the achieved fraction of whichever wall of
``roofline.analysis.DEVICE_PEAKS`` binds) follow.  A row the cost model
calls infeasible takes the one-read-one-write bytes, names the reason in
``roofline_fallback`` and is listed after the grid.  ``--report`` renders
the gearshifft Fig. 7 table from the written document.

On the card each repetition is timed with CUDA events around the one
forward, after a write of a 256 MiB scratch buffer that evicts the 50 MB
L2 (a small row read from a warm L2 would otherwise beat HBM).  On the
CPU, where every kernel backend runs its plain version, the host clock
times it.  ``--device`` defaults to ``cuda:0``; with no card the run
raises, and it runs on the CPU only when asked with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import platform
import statistics
import subprocess
import time

import torch

from ..core.candidates import Candidate, backend_supports
from ..core.client import Problem, TorchContext
from ..core.clients.torch_fft import _forward_fn
from ..core.compare import fig7_report, load_bench, make_meta
from ..core.costmodel import get_active_model
from ..core.extents import classify, parse_extents
from ..roofline.analysis import fft_model_flops, fft_roofline_frac

DEFAULT_EXTENTS = ("1024", "4096", "16384", "65536",        # 1D powerof2
                   "3072", "18432",                         # 1D radix357
                   "6859",                                  # 1D oddshape 19^3
                   "64x64", "256x256",                      # 2D (fft2 range)
                   "32x32x32")                              # 3D
SMOKE_EXTENTS = ("256", "1024", "12", "19", "16x16", "8x8x8")

DEFAULT_BACKENDS = ("xla", "stockham", "fourstep", "fourstep_pallas",
                    "stockham_pallas", "sixstep", "fft2_pallas",
                    "chirpz_pallas", "bluestein")

#: Bytes written between timed repetitions on the card: over five times
#: the H100's 50 MB L2, so every repetition reads its signal from HBM.
L2_FLUSH_BYTES = 256 << 20

#: The grid's input seed (the reference's ``default_rng(0)``).
SEED = 0


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


class RepTimer:
    """Times one call of a transform: CUDA events after an L2 flush on
    the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.flush = (torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                                  device=device)
                      if device.type == "cuda" else None)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, fn, x) -> float:
        """Seconds of one ``fn(x)``."""
        if self.flush is None:
            t0 = time.perf_counter()
            fn(x)
            return time.perf_counter() - t0
        self.flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3


def _record_times(rec: dict, times: list[float]) -> float:
    """min/mean/sd/n columns from per-rep times (seconds); returns the
    best.  The sd/n columns are what bench_diff's pooled-noise gate reads
    (a 1-rep run records sd 0, n 1: no spread information)."""
    best = min(times)
    rec["time_ms"] = best * 1e3
    rec["mean_ms"] = statistics.fmean(times) * 1e3
    rec["sd_ms"] = statistics.stdev(times) * 1e3 if len(times) > 1 else 0.0
    rec["n"] = len(times)
    return best


def _annotate_roofline(rec: dict, problem: Problem, cand: Candidate,
                       best_s: float, device_kind: str) -> None:
    """The bytes-based FFT roofline of an ok row: modeled flops, modeled
    bytes from the active cost model (so an installed fitted table flows
    into ``roofline_frac``), and the achieved fraction.  An
    :class:`~repro_torch.core.costmodel.Infeasible` verdict degrades to
    the one-read-one-write minimum and names its reason in
    ``roofline_fallback``: a row that ran but models as infeasible means
    the model's feasibility rules have drifted from the kernels'."""
    flops = fft_model_flops(problem.extents, problem.batch)
    verdict = get_active_model().estimate(problem, cand)
    bytes_ = float(verdict)
    if not (0.0 < bytes_ < float("inf")):
        bytes_ = 2.0 * problem.signal_bytes
        rec["roofline_fallback"] = (getattr(verdict, "reason", "")
                                    or "non-finite model bytes")
    rec["model_flops"] = flops
    rec["model_bytes"] = bytes_
    rec["roofline_frac"] = fft_roofline_frac(best_s * 1e3, flops, bytes_,
                                             device_kind)


def bench_backend(backend: str, extents: tuple[int, ...], x: torch.Tensor,
                  reps: int, warmups: int, timer: RepTimer,
                  device_kind: str) -> dict:
    """One grid row: ``backend``'s forward of the batch ``x`` (complex64,
    ``(batch, *extents)``).  An unsupported or failing row is recorded,
    not raised."""
    batch = x.shape[0]
    problem = Problem(extents, "Outplace_Complex", "float", batch=batch)
    rec = {"backend": backend, "extent": "x".join(map(str, extents)),
           "rank": len(extents), "batch": batch,
           "kind": problem.kind, "precision": problem.precision,
           "class": classify(extents)}
    if not backend_supports(backend, problem):
        rec.update(ok=False, error="unsupported extents/rank")
        return rec
    try:
        cand = Candidate(backend)
        fn = _forward_fn(problem, cand, timer.device)
        t0 = time.perf_counter()
        fn(x)
        timer.sync()
        rec["compile_ms"] = (time.perf_counter() - t0) * 1e3
        for _ in range(warmups):
            fn(x)
        timer.sync()
        best = _record_times(rec, [timer(fn, x) for _ in range(reps)])
        moved = 2 * x.numel() * x.element_size()   # one read + one write
        rec["gib_per_s"] = moved / best / 2**30
        _annotate_roofline(rec, problem, cand, best, device_kind)
        rec["ok"] = True
    except Exception as e:  # infeasible extent for this backend: record it
        rec.update(ok=False, error=f"{type(e).__name__}: {e}")
    return rec


def grid_input(extents: tuple[int, ...], batch: int,
               device: torch.device) -> torch.Tensor:
    """The grid's seeded complex64 batch, made on the device."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    return torch.randn((batch, *extents), dtype=torch.complex64,
                       generator=gen, device=device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True, help="BENCH document to write")
    p.add_argument("--backends", nargs="+", default=None)
    p.add_argument("--extents", nargs="+", default=None,
                   help="extent specs like 4096 64x64 16x16x16")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--warmups", type=int, default=1)
    p.add_argument("--smoke", action="store_true",
                   help="tiny grid, 1 rep, no warmup")
    p.add_argument("--device", default="cuda:0",
                   help="torch device (default cuda:0; cpu runs the "
                        "kernels' plain versions)")
    p.add_argument("--report", default=None, metavar="PATH",
                   help="also write the gearshifft Fig. 7 markdown "
                        "(backend x extent class x achieved roofline "
                        "fraction) rendered from the written document")
    args = p.parse_args(argv)

    if args.smoke:
        extents, reps, warmups = args.extents or SMOKE_EXTENTS, 1, 0
    else:
        extents = args.extents or DEFAULT_EXTENTS
        reps, warmups = args.reps, args.warmups
    backends = list(args.backends or DEFAULT_BACKENDS)
    grid = [parse_extents(str(e)) for e in extents]

    context = TorchContext(args.device)
    context.create()             # raises without the device; builds kernels
    device, kind = context.device, context.device_kind
    gpu = device.type == "cuda"
    timer = RepTimer(device)
    meta = dict(
        device_kind=kind, platform="gpu" if gpu else "cpu",
        devices=torch.cuda.device_count() if gpu else 1,
        interpret_kernels=not gpu, python=platform.python_version(),
        torch=torch.__version__, batch=args.batch, reps=reps,
        note="forward c64 transform, min-of-reps (mean/sd/n per row); "
             "CUDA events after an L2 flush on the card; gib_per_s "
             "assumes the one-read+one-write algorithmic minimum; "
             "roofline_frac is the achieved fraction of the modeled device "
             "roofline (5*N*log2(N) flops, planner bytes-moved model)")
    if gpu:
        meta["power_limit"] = power_limit()
    doc = {"meta": make_meta(**meta), "results": []}
    for ext in grid:
        x = grid_input(ext, args.batch, device)
        for backend in backends:
            rec = bench_backend(backend, ext, x, reps, warmups, timer, kind)
            rec["devices"] = 1
            doc["results"].append(rec)
            status = (f"{rec['time_ms']:9.3f} ms  {rec['gib_per_s']:7.2f} GiB/s"
                      if rec["ok"] else f"infeasible: {rec['error']}")
            print(f"{rec['extent']:>12s} {backend:16s} {status}")
        del x
    fallbacks = [r for r in doc["results"] if "roofline_fallback" in r]
    if fallbacks:
        print(f"{len(fallbacks)} row(s) used the 2x-signal-bytes roofline "
              "fallback (model called them infeasible):")
        for r in fallbacks:
            print(f"  {r['backend']} @ {r['extent']}: "
                  f"{r['roofline_fallback']}")
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    if args.report:
        with open(args.report, "w") as f:
            f.write(fig7_report(load_bench(args.out)))
        print(f"wrote Fig. 7 report to {args.report}")
    print(f"wrote {len(doc['results'])} records to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
