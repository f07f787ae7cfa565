#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together, into ``build/kernels/``);
3. holds each kernel against its plain PyTorch version on the card, and
   against ``torch.fft``, over lengths (shapes), radices, dtypes,
   directions, tile 1 and a ragged last tile (the dft kernel at every n
   from 1 to 128); then the kernels' multi-pass paths, over one block's
   shared memory up to the reference's caps (Stockham to 2^20, fft2 to
   2^18 points, the four-step kernel's two launches in complex128), a
   few rows each, forward and inverse; then the real-input folds of the
   one-block kernels (the Stockham kernel's rfft / irfft, the fused rank-2
   kernel's rfft2 / irfft2) over fixed cases against their plain versions
   (``fft/rfft.py``'s packing around the plain stages) and ``torch.fft``;
4. drives the port's main path at full size: ``Session.run`` of each
   client on its problems (``TorchFFT``, ``TorchStockhamPallas`` and
   ``TorchFourStepPallas`` on P1-P7, ``TorchFft2Pallas`` on P6-P7), every
   node round-trip validated; each client's path runs with every launch
   count set to 0 just before it and read just after, which shows that the
   path went through its kernel and through no other; the real kinds of
   P1, P4, P5 and P6 on ``TorchStockhamPallas`` and P6 on
   ``TorchFft2Pallas`` launch the folds and call none of ``fft/rfft.py``'s
   packing;
5. shows that ``TorchFft2Pallas`` on a problem its kernel cannot take (P1,
   rank 3) is a failed node that launched nothing;
6. drives the reference's ``backends`` table's two nodes that need the
   passes (65536 Outplace_Real under ``TorchStockhamPallas``, 256 x 256
   Outplace_Real under ``TorchFft2Pallas``) through ``Session.run``, each
   with the launch counts set to 0 just before it and read just after:
   each validates and launches its own kernel and no other;
7. drives the large-N and oddshape paths at full size (P10-P14, about
   512 MiB each way): ``Session.run`` of ``TorchSixStep`` on P10-P11,
   ``TorchChirpZPallas`` on P12-P14, ``TorchBluestein`` on P12-P14 and
   ``TorchFFT`` on P10-P14, each node validated, with the launch counts
   set to 0 just before it and read just after: a six-step node launches
   the Stockham and four-step kernels and no other, a chirp-Z node the
   Stockham kernel (and the four-step kernel at P12, whose padded m = 2^18
   runs six-step), the Bluestein baseline and torch.fft none;
8. drives the planner: ``TorchPlanned`` under ESTIMATE on P1-P14 (the
   reference's picks, each node launching its pick's kernels and no
   other; the ``dft_matmul`` kernel's main path, on P8 and P9), under
   MEASURE on P1-P9 and P12-P14 with a wisdom file under ``build/``
   (every candidate of the port's ``candidates()`` built and timed
   finite), the pinned kernel clients under PATIENT into the same file
   (each sweeping only its own knobs; ``TorchSixStep`` on P10,
   ``TorchChirpZPallas`` on P13), every swept candidate's forward against
   torch.fft's on MEASURE's input, then under WISDOM_ONLY on that file
   (every node planned from wisdom, launching only the recorded pick's
   kernels);
9. runs the ported ``backends`` and ``radix`` tables (the paper's Figs. 6
   and 7) through ``Session.run``: every node its client supports
   validates, the others are failed nodes; then their entry point
   ``python -m repro_torch.benchmarks.run backends radix``;
10. drives the gearshifft CLI (``repro_torch.core.cli.main``) in process
   at the main path's full sizes (P1 on ``TorchFFT``,
   ``TorchStockhamPallas`` and ``TorchPlanned``; P3 on the Stockham and
   four-step clients into the JSONL sink; P7 on ``TorchFft2Pallas``; P8 on
   ``TorchPlanned``, whose ESTIMATE pick launches the dft kernel), with the
   launch counts set to 0 just before each node and read just after:
   every node validated, launching its client's (or pick's) kernels and
   no other, P1's Stockham node through the R2C fold and none of
   ``fft/rfft.py``'s packing, every file in the reference's columns; a
   ``-r`` selection gives exactly ``tree.select``'s nodes;
   ``--dump-config`` writes P3's spec, equal to the invocation's with the
   same tree, and ``python -m repro_torch.core.cli --config`` replays it
   as a program at one repetition (the same columns); then the
   paper's ``overhead``, ``tts``, ``plan_rigor`` and ``dtypes`` tables
   (Figs. 2, 3, 4-5 and 8) through ``Session.run`` (every node its client
   supports validates; their rows emitted as CSV; ``plan_rigor`` with
   its ``estimate_fitted`` rows, and ``TorchPlanned``'s pick at every
   repetition logged, MEASURE's beside WISDOM_ONLY's), and their entry
   point ``python -m repro_torch.benchmarks.run overhead tts plan_rigor
   dtypes``;
11. the perf-trajectory phase: the bench grid's smoke mode
   (``repro_torch.benchmarks.bench_grid``) on the card, every row the
   support rules admit ok and launching its backend's kernels and no
   other, every other row the unsupported row; the committed
   ``BENCH_h100.json``'s large rows no faster than 1.05 x one HBM read
   and write, its rows over a roofline fraction of 1 printed; ESTIMATE
   under the fitted ``costmodel_h100.json`` on P1-P14 beside the
   hand-written and MEASURE's picks, every node whose fitted pick differs
   through ``Session.run``, validated and launching its pick's kernels;
12. holds the fused fftconv kernel against its plain version and the
   float64 oracle on fixed cases (every k, ragged tiles, every tile that
   fits), then drives its path: the port's kernel table
   (``repro_torch.benchmarks.table_kernels``) at the reference's sizes
   through ``Session.run``, every node validated and launching its
   client's kernel and no other, each kernel client's download against
   its plain counterpart; then the fused and unfused fftconv clients at a
   Hyena long convolution's width (F2, F3), with the launch counts set to
   0 before the table and read after F3;
13. holds each kernel against its plain version at every shape the main
   path (P1-P14), the backends nodes and the sweeps launched it with
   (radix 8 and the default tile, both directions; fftconv against its
   plain version and the float64 oracle), then times it at the main
   path's shapes beside its plain version, the library call
   (``torch.fft``; for fftconv the unfused ``torch.fft`` path) and its
   bound, and sweeps the batch tile of the fftconv and four-step kernels
   there (the check on their defaults); then checks and times the
   multi-pass paths, the fused rank-2 kernel's complex transform of P6's
   tile and the dft kernel's direct product at 512 MiB shapes
   (``EXTRA_TIMING``);
14. prints the kernel summary and, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits nonzero.  It needs a CUDA
device and the repository's ``src/`` beside it.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM data sheet: HBM3 rate, and the highest full-precision peak of
#: each type (fp32 outside the tensor cores; fp64 on the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"complex64": 67e12, "complex128": 67e12, "float32": 67e12}
#: The TF32 tensor-core peak (dense), which the four-step kernel's
#: complex64 products run at (3xTF32).
PEAK_TF32 = 495e12

#: CUDA-event repetitions of the timing phases (the median is kept): a
#: kernel and its library call, and the far slower plain versions.
TIMING_REPS = 10
PLAIN_REPS = 3

CHECK_NS = (2, 3, 8, 12, 100, 945, 1024, 3072, 4096)
CHECK_RADICES = (2, 4, 8)
CHECK_BATCHES = (1, 37)
#: fused rank-2 kernel: 2x2 up to each dtype's cap (8192 / 4096 points)
FFT2_SHAPES = {
    "complex64": ((2, 2), (1, 8), (8, 1), (4, 16), (16, 4), (32, 32),
                  (8, 256), (64, 128), (128, 64), (2, 4096)),
    "complex128": ((2, 2), (1, 8), (8, 1), (4, 16), (16, 4), (32, 32),
                   (8, 256), (64, 64), (32, 128), (4096, 1)),
}
#: four-step kernel: square, ragged-split and radix357 lengths, 8192 (and
#: the cap: 16384 in complex64)
FOURSTEP_NS = (4, 60, 100, 945, 1024, 3072, 4096, 8192)
#: rows of the fixed-case checks: tile 1, and tile 8 (a ragged last tile
#: of 5) where 8 signals fit one block
CHECK_ROWS = 37
#: dft_matmul kernel: every length up to its cap of 128 (the FFT body on
#: the 7-smooth ones, the direct product on the rest)
DFT_NS = tuple(range(1, 129))
#: The multi-pass paths, a few rows each: Stockham lengths over one
#: block (two column passes; 76545 = 945 x 81 splits 243 x 315, not a
#: power of two), fft2 tiles over one block (a row pass and a column
#: pass), four-step complex128 lengths whose plane one block does not
#: hold (two launches).
CAPACITY_STOCKHAM = {"complex64": (16384, 76545, 1 << 20),
                     "complex128": (8192, 65536, 76545)}
CAPACITY_FFT2 = ((128, 128), (256, 256), (512, 512))
CAPACITY_FOURSTEP = (13824, 16384)
CAPACITY_ROWS = 3
#: The real-input folds' fixed cases: Stockham rfft / irfft lengths (even n
#: packed to n/2 points, n = 2 to one; odd n whole; P1's, P4's and P5's
#: axes) with each dtype's largest even and odd length one block folds;
#: fft2 rfft2 / irfft2 tiles (an even last extent, the packed tile up to
#: one block's cap); tile 1, 8 where it fits, and the default.
FOLD_NS = (2, 3, 4, 5, 12, 15, 128, 256, 945, 1536, 3072)
FOLD2_SHAPES = {
    "complex64": ((1, 2), (2, 2), (4, 16), (16, 4), (8, 256), (128, 128),
                  (64, 256)),
    "complex128": ((1, 2), (2, 2), (4, 16), (16, 4), (8, 256), (64, 128),
                   (32, 256)),
}
#: Main-path nodes that must run their real kind through a fold:
#: (client, problem, the fold keys of LAUNCH_SHAPES it launches).
FOLD_NODES = {("TorchStockhamPallas", "P1"): ("rfft", "irfft"),
              ("TorchStockhamPallas", "P4"): ("rfft", "irfft"),
              ("TorchStockhamPallas", "P5"): ("rfft", "irfft"),
              ("TorchStockhamPallas", "P6"): ("rfft", "irfft"),
              ("TorchFft2Pallas", "P6"): ("rfft2", "irfft2")}
#: The reference's backends table's nodes (benchmarks/table_backends.py)
#: that need the passes: (client, extents, the kernel it launches).
BACKENDS_NODES = (("TorchStockhamPallas", (65536,), "stockham_pallas"),
                  ("TorchFft2Pallas", (256, 256), "fft2_pallas"))
#: Shapes timed beside the main path's, each moving 512 MiB each way:
#: the dft kernel's direct product at n = 127 (P8's bytes), the fused
#: rank-2 kernel's complex transform of P6's packed tile (the main path
#: runs P6 through the fold), the Stockham kernel's two passes, fft2's
#: passes, the four-step kernel's two launches.
EXTRA_TIMING = (("dft_matmul", (127, 524288, "complex64")),
                ("fft2_pallas", (128, 64, 8192, "complex64")),
                ("stockham_pallas", (65536, 1024, "complex64")),
                ("stockham_pallas", (1 << 20, 64, "complex64")),
                ("fft2_pallas", (256, 256, 1024, "complex64")),
                ("fft4step", (16384, 2048, "complex128")))
#: kernel vs its plain version: same algorithm and twiddles, only the
#: summation order differs.
PLAIN_TOL = {"complex64": 1e-5, "complex128": 1e-12}
#: kernel vs torch.fft: the suite's accuracy bar.
LIBRARY_TOL = {"complex64": 1e-3, "complex128": 1e-8}

#: The main path's problems: (name, extents, kind, precision, batch).
PROBLEMS = (
    ("P1", (256, 256, 256), "Outplace_Real", "float", 1),
    ("P2", (128, 128, 128), "Inplace_Complex", "double", 1),
    ("P3", (4096,), "Outplace_Complex", "float", 16384),
    ("P4", (3072, 3072), "Outplace_Real", "float", 1),
    ("P5", (945,), "Inplace_Real", "float", 65536),
    ("P6", (128, 128), "Outplace_Real", "float", 8192),
    ("P7", (64, 64), "Inplace_Complex", "double", 8192),
    ("P8", (128,), "Outplace_Complex", "float", 524288),
    ("P9", (100,), "Inplace_Real", "double", 655360),
    ("P10", (1 << 22,), "Outplace_Complex", "float", 16),
    ("P11", (1 << 24,), "Inplace_Complex", "double", 2),
    ("P12", (19 ** 4,), "Outplace_Complex", "float", 512),
    ("P13", (19 ** 3,), "Inplace_Real", "double", 8192),
    ("P14", (361, 361), "Outplace_Real", "float", 1024),
)
ALL = ("P1", "P2", "P3", "P4", "P5", "P6", "P7")
#: The large-N and oddshape problems, about 512 MiB each way: six-step at
#: 256 x 16384 (P10) and at its cap 1024 x 16384 in complex128 (P11), the
#: chirp-Z path on powers of 19 (P12: "auto" runs six-step at m = 2^18;
#: P13: an odd real axis, m = 13720 complex128, the Stockham kernel's two
#: column passes; P14: per axis, m = 729 in one block).
LARGE = ("P10", "P11", "P12", "P13", "P14")
#: Their paths: (client, its problems, the kernels each node launches and
#: no other).
LARGE_PATHS = (
    ("TorchSixStep", ("P10", "P11"), ("stockham_pallas", "fft4step")),
    ("TorchChirpZPallas", ("P12",), ("stockham_pallas", "fft4step")),
    ("TorchChirpZPallas", ("P13", "P14"), ("stockham_pallas",)),
    ("TorchBluestein", ("P12", "P13", "P14"), ()),
    ("TorchFFT", LARGE, ()),
)
#: The problems TorchPlanned plans under MEASURE (every candidate timed)
#: and then WISDOM_ONLY: P1-P9 and the oddshape ones.
MEASURE_NAMES = ("P1", "P2", "P3", "P4", "P5", "P6", "P7", "P8", "P9",
                 "P12", "P13", "P14")
#: A problem whose PATIENT grid holds fused rank-2 knobs (P6 and P7 sit at
#: the kernel's cap, where no batch tile but the default fits a block).
PATIENT_PROBLEMS = (
    ("F1", (32, 32), "Outplace_Complex", "float", 262144),
)
#: The pinned clients' PATIENT paths: (client, problem); each sweeps only
#: its own kernel's knobs.
PATIENT_PATHS = (("TorchStockhamPallas", "P5"), ("TorchFourStepPallas", "P5"),
                 ("TorchFft2Pallas", "F1"), ("TorchSixStep", "P10"),
                 ("TorchChirpZPallas", "P13"))
#: TorchPlanned's ESTIMATE picks on P1-P14: the reference's
#: ``repro.core.costmodel.estimate_choice`` (tests/test_torch_planner.py
#: holds the port's picks to it).
ESTIMATE_PICKS = {"P1": "xla", "P2": "xla", "P3": "fourstep_pallas",
                  "P4": "xla", "P5": "fourstep_pallas", "P6": "fft2_pallas",
                  "P7": "fft2_pallas", "P8": "dft", "P9": "dft",
                  "P10": "xla", "P11": "xla", "P12": "xla",
                  "P13": "chirpz_pallas", "P14": "fourstep_pallas"}
#: The kernel each planner backend launches (none for torch.fft and the
#: plain-torch baselines; six-step and chirp-Z: see ``_kernels_of``).
BACKEND_KERNEL = {"stockham_pallas": "stockham_pallas",
                  "fourstep_pallas": "fft4step", "fft2_pallas": "fft2_pallas",
                  "dft": "dft_matmul"}
WISDOM_PATH = os.path.join(ROOT, "build", "chip_smoke_wisdom.json")
CLI_DIR = os.path.join(ROOT, "build", "cli")
#: The CLI at the main path's full sizes: (problem, argv, per client the
#: kernels each of its nodes launches and no other).  P1's Stockham node
#: runs its real kind through the fold (``FOLD_NODES``); TorchPlanned's
#: ESTIMATE picks are cuFFT at P1 and the dft kernel at P8.
CLI_RUNS = (
    ("P1", ["-e", "256x256x256", "--kinds", "Outplace_Real", "--client",
            "TorchFFT", "TorchStockhamPallas", "TorchPlanned",
            "-o", os.path.join(CLI_DIR, "p1.csv")],
     {"TorchFFT": (), "TorchStockhamPallas": ("stockham_pallas",),
      "TorchPlanned": ()}),
    ("P3", ["-e", "4096", "-b", "16384", "--kinds", "Outplace_Complex",
            "--client", "TorchStockhamPallas", "TorchFourStepPallas",
            "-o", os.path.join(CLI_DIR, "p3.jsonl")],
     {"TorchStockhamPallas": ("stockham_pallas",),
      "TorchFourStepPallas": ("fft4step",)}),
    ("P7", ["-e", "64x64", "-b", "8192", "--precisions", "double",
            "--kinds", "Inplace_Complex", "--client", "TorchFft2Pallas",
            "-o", os.path.join(CLI_DIR, "p7.csv")],
     {"TorchFft2Pallas": ("fft2_pallas",)}),
    ("P8", ["-e", "128", "-b", "524288", "--kinds", "Outplace_Complex",
            "--client", "TorchPlanned", "-o", os.path.join(CLI_DIR, "p8.csv")],
     {"TorchPlanned": ("dft_matmul",)}),
)
#: A ``-r`` selection over a two-client, two-kind tree (one node of four).
CLI_SELECT = (["-e", "1024", "-b", "64", "--kinds", "Outplace_Complex",
               "Inplace_Real", "--client", "TorchStockhamPallas",
               "TorchFourStepPallas", "-r", "TorchFourStep*/*/*/Inplace_Real",
               "-o", os.path.join(CLI_DIR, "select.csv")],
              {"TorchFourStepPallas": ("fft4step",)})
#: The trajectory phase's files, and the committed H100 baselines
#: (``BENCH_h100.json``, ``wisdom_h100.json``, ``costmodel_h100.json``).
TRAJECTORY_DIR = os.path.join(ROOT, "build", "trajectory")
BASELINES = os.path.join(SRC, "repro_torch", "benchmarks", "baselines")
#: A grid row at least this large each way cannot move its signal faster
#: than one HBM read and write: the L2 (50 MB) holds none of it.
LARGE_ROW_BYTES = 100 << 20
#: The paper tables the CLI phase runs: Figs. 2, 3, 4-5 and 8.
PAPER_TABLES = ("overhead", "tts", "plan_rigor", "dtypes")
#: Each client's main path: (client, its problems, the kernel it runs).
PATHS = (
    ("TorchFFT", ALL, None),
    ("TorchStockhamPallas", ALL, "stockham_pallas"),
    ("TorchFourStepPallas", ALL, "fft4step"),
    ("TorchFft2Pallas", ("P6", "P7"), "fft2_pallas"),
)
#: The ported kernels: (name, CUDA source, the TPU kernel it replaces).
KERNELS = (
    ("stockham_pallas", "src/repro_torch/csrc/stockham.cu",
     "src/repro/kernels/stockham_pallas/stockham_pallas.py:177"),
    ("fft2_pallas", "src/repro_torch/csrc/fft2.cu",
     "src/repro/kernels/fft2_pallas/fft2_pallas.py:63"),
    ("fft4step", "src/repro_torch/csrc/fft4step.cu",
     "src/repro/kernels/fft4step/fft4step.py:70"),
    ("dft_matmul", "src/repro_torch/csrc/dft.cu",
     "src/repro/kernels/dft_matmul/dft_matmul.py:45"),
    ("fftconv", "src/repro_torch/csrc/fftconv.cu",
     "src/repro/kernels/fftconv/fftconv.py:72"),
)
#: fftconv kernel against its plain version and the float64 oracle: the
#: same arithmetic in another summation order; a float32 model of it
#: agrees with float64 convolution to ~3e-7 at n = 16384.
CONV_TOL = 1e-5
#: fftconv fixed cases: every length n = k*k the length rule yields, (C, B)
#: with a ragged last tile of 5 in tiles of 2 to 4 (and 5 signals in a
#: tile of 6 or more), every tile up to the largest that fits, and the
#: reference test's cases (C, B, L, K).
CONV_KS = (1, 2, 4, 8, 16, 32, 64, 128)
CONV_CB = ((1, 1), (3, 5))
CONV_REFERENCE_CASES = ((2, 4, 100, 5), (1, 1, 512, 64), (3, 2, 1000, 24),
                        (2, 8, 8000, 128))
#: fftconv at a Hyena long convolution's width (d_model 768, a filter as
#: long as the sequence; Poli et al. 2023): (name, channels, signals per
#: channel, L = K).  n = 4096 and n = 16384 (the cap).
CONV_WIDTHS = (("F2", 768, 32, 2048), ("F3", 768, 8, 8192))
#: The kernel each kernel-table client launches (None: plain torch or
#: torch.fft only), and the pairs whose downloads must agree.
TABLE_KERNEL = {"KernelFft4StepCuda": "fft4step",
                "KernelFourStepTorch": None,
                "KernelStockhamPallasCuda": "stockham_pallas",
                "KernelStockhamTorch": None,
                "KernelFftconvFused": "fftconv",
                "KernelFftconvUnfused": None,
                "KernelFft2PallasCuda": "fft2_pallas",
                "KernelFft2Separable": "stockham_pallas"}
TABLE_PAIRS = (("KernelFft4StepCuda", "KernelFourStepTorch"),
               ("KernelStockhamPallasCuda", "KernelStockhamTorch"),
               ("KernelFftconvFused", "KernelFftconvUnfused"),
               ("KernelFft2PallasCuda", "KernelFft2Separable"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_l2(got, want) -> float:
    return float((got - want).abs().norm() / want.abs().norm().clamp_min(1e-300))


def card_info() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.split(",", 1))
    return {"card": name, "power_limit": limit}


def kernel_ops(name: str):
    """The wrapper module (``ops``) and plain versions (``ref``) of a
    kernel."""
    import importlib
    base = f"repro_torch.kernels.{name}"
    return (importlib.import_module(f"{base}.ops"),
            importlib.import_module(f"{base}.ref"))


def build() -> float:
    from repro_torch.kernels import _build
    names = _build.sources()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.library, names))
    seconds = time.perf_counter() - t0
    for name in names:
        print(_build.build_log(name), file=sys.stderr)
    return seconds


class Worst:
    """The worst errors over a kernel's checks."""

    def __init__(self, kernel: str, dtype: str):
        self.row = {"check": "kernel_vs_plain", "kernel": kernel,
                    "dtype": dtype, "cases": 0, "rel_l2_plain": 0.0,
                    "rel_l2_library": 0.0, "max_abs_err": 0.0}

    def add(self, y, plain, lib, what: str) -> None:
        name = self.row["dtype"]
        e_plain, e_lib = rel_l2(y, plain), rel_l2(y, lib)
        if not (e_plain <= PLAIN_TOL[name] and e_lib <= LIBRARY_TOL[name]):
            raise AssertionError(
                f"{self.row['kernel']} kernel disagrees: {what} {name}: "
                f"rel_l2 vs plain {e_plain:.3e}, vs torch.fft {e_lib:.3e}")
        self.row["cases"] += 1
        self.row["rel_l2_plain"] = max(self.row["rel_l2_plain"], e_plain)
        self.row["rel_l2_library"] = max(self.row["rel_l2_library"], e_lib)
        self.row["max_abs_err"] = max(self.row["max_abs_err"],
                                      float((y - plain).abs().max()))


def check_stockham(device, gen, dtype) -> Worst:
    import torch
    ops, ref = kernel_ops("stockham_pallas")
    name = str(dtype).removeprefix("torch.")
    w = Worst("stockham_pallas", name)
    w.row["max_n"] = ops.MAX_N[dtype]
    for n in CHECK_NS + (ops.ONE_BLOCK_N[dtype],):
        for radix in CHECK_RADICES:
            for batch in CHECK_BATCHES:
                x = torch.randn((batch, n), dtype=dtype, device=device,
                                generator=gen)
                fits = ops.smem_bytes(n, 8, x.element_size(), 2) \
                    <= ops.SMEM_LIMIT_BYTES
                tile = 8 if fits else 1   # 37 rows: a ragged last tile
                for inverse in (False, True):
                    y = ops.fft(x, inverse, radix=radix, tile_b=tile)
                    torch.cuda.synchronize(device)
                    w.add(y, ref.stockham_ref(x, radix, inverse),
                          (torch.fft.ifft if inverse else torch.fft.fft)(x),
                          f"n={n} radix={radix} batch={batch} "
                          f"inverse={inverse}")
    return w


def check_fft2(device, gen, dtype) -> Worst:
    import torch
    ops, ref = kernel_ops("fft2_pallas")
    name = str(dtype).removeprefix("torch.")
    w = Worst("fft2_pallas", name)
    w.row["max_elems"] = ops.MAX_ELEMS[dtype]
    for n1, n2 in FFT2_SHAPES[name]:
        x = torch.randn((CHECK_ROWS, n1, n2), dtype=dtype, device=device,
                        generator=gen)
        fits = ops.smem_bytes(n1 * n2, 8, x.element_size(), 2) \
            <= ops.SMEM_LIMIT_BYTES
        for radix in CHECK_RADICES:
            for tile in ((1, 8) if fits else (1,)):
                for inverse in (False, True):
                    y = ops.fft2(x, inverse, radix=radix, tile_b=tile)
                    torch.cuda.synchronize(device)
                    w.add(y, ref.fft2_ref(x, radix, inverse),
                          (torch.fft.ifft2 if inverse else torch.fft.fft2)(x),
                          f"{n1}x{n2} radix={radix} tile_b={tile} "
                          f"inverse={inverse}")
    return w


def check_fourstep(device, gen, dtype) -> Worst:
    import torch
    ops, ref = kernel_ops("fft4step")
    name = str(dtype).removeprefix("torch.")
    w = Worst("fft4step", name)
    w.row["max_n"] = ops.MAX_N[dtype]
    for n in FOURSTEP_NS + (ops.MAX_N[dtype],):
        x = torch.randn((CHECK_ROWS, n), dtype=dtype, device=device,
                        generator=gen)
        n1, n2 = ops.choose_factors(n)
        fits = ops.smem_bytes(n1, n2, 8, x.element_size()) \
            <= ops.SMEM_LIMIT_BYTES
        one = ops.one_block(n1, n2, x.element_size())
        for tile in ((1, 8) if fits else (1,) if one else (None,)):
            for inverse in (False, True):
                y = ops.fft(x, inverse, tile_b=tile)
                torch.cuda.synchronize(device)
                w.add(y, ref.fft4step_ref(x, inverse),
                      (torch.fft.ifft if inverse else torch.fft.fft)(x),
                      f"n={n} ({n1}x{n2}) tile_b={tile} inverse={inverse}")
    return w


def check_dft(device, gen, dtype) -> Worst:
    import torch
    ops, ref = kernel_ops("dft_matmul")
    name = str(dtype).removeprefix("torch.")
    w = Worst("dft_matmul", name)
    w.row["max_n"] = 128
    for n in DFT_NS:
        x = torch.randn((CHECK_ROWS, n), dtype=dtype, device=device,
                        generator=gen)
        for inverse in (False, True):
            m = ops.make_matrix(n, inverse, dtype, device)
            plain = ops.plain(x, m, inverse)
            lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
            for tile in (1, 8):     # 37 rows in tiles of 8: a ragged tile
                y = ops.dft(x, inverse, tile_b=tile, matrix=m)
                torch.cuda.synchronize(device)
                w.add(y, plain, lib, f"n={n} tile_b={tile} "
                      f"inverse={inverse} ({'FFT' if m.fft else 'direct'})")
    return w


def _dft_plain(ref, x, inverse: bool):
    """The reference's plain DFT on planes (the direct product), normalized
    as ``ops.dft``: the oracle of every dft shape."""
    import torch
    yr, yi = ref.dft_ref(x.real.contiguous(), x.imag.contiguous(), inverse)
    y = torch.complex(yr, yi)
    return y / x.shape[-1] if inverse else y


def check_kernels(device) -> dict:
    """Every kernel vs its plain version (on the card) and vs torch.fft;
    raises on a miss.  Returns the worst errors per kernel and dtype."""
    import torch
    gen = torch.Generator(device=device).manual_seed(2017)
    worst = {}
    for kernel, check in (("stockham_pallas", check_stockham),
                          ("fft2_pallas", check_fft2),
                          ("fft4step", check_fourstep),
                          ("dft_matmul", check_dft)):
        for dtype in (torch.complex64, torch.complex128):
            w = check(device, gen, dtype)
            emit(w.row)
            worst[(kernel, w.row["dtype"])] = w.row
    return worst


def check_capacity(device) -> dict:
    """The multi-pass paths (``CAPACITY_*``) against their plain versions
    and torch.fft, forward and inverse, at the kernels' bars; raises on a
    miss.  Returns the worst errors per kernel and dtype."""
    import torch
    gen = torch.Generator(device=device).manual_seed(2020)
    worst = {}
    sp, _ = kernel_ops("stockham_pallas")
    f2, _ = kernel_ops("fft2_pallas")
    fs, fs_ref = kernel_ops("fft4step")
    for dtype in (torch.complex64, torch.complex128):
        name = str(dtype).removeprefix("torch.")
        rows = []
        w = Worst("stockham_pallas", name)
        for n in CAPACITY_STOCKHAM[name]:
            x = torch.randn((CAPACITY_ROWS, n), dtype=dtype, device=device,
                            generator=gen)
            for inverse in (False, True):
                plan = sp.make_twiddles(n, 8, inverse, dtype, device)
                y = sp.fft(x, inverse, twiddles=plan)
                torch.cuda.synchronize(device)
                plain = sp.plain(x, plan, inverse)
                w.add(y, plain / n if inverse else plain,
                      (torch.fft.ifft if inverse else torch.fft.fft)(x),
                      f"n={n} split {plan.n1}x{plan.n2} inverse={inverse}")
        rows.append(w)
        w = Worst("fft2_pallas", name)
        for n1, n2 in CAPACITY_FFT2:
            x = torch.randn((CAPACITY_ROWS, n1, n2), dtype=dtype,
                            device=device, generator=gen)
            for inverse in (False, True):
                plan = f2.make_twiddles2(n1, n2, 8, inverse, dtype, device)
                y = f2.fft2(x, inverse, twiddles=plan)
                torch.cuda.synchronize(device)
                plain = f2.plain(x, plan, inverse)
                w.add(y, plain / (n1 * n2) if inverse else plain,
                      (torch.fft.ifft2 if inverse else torch.fft.fft2)(x),
                      f"{n1}x{n2} inverse={inverse}")
        rows.append(w)
        if dtype == torch.complex128:
            w = Worst("fft4step", name)
            for n in CAPACITY_FOURSTEP:
                x = torch.randn((CAPACITY_ROWS, n), dtype=dtype,
                                device=device, generator=gen)
                for inverse in (False, True):
                    t = fs.make_tables(n, inverse, dtype, device)
                    y = fs.fft(x, inverse, twiddles=t)
                    torch.cuda.synchronize(device)
                    plain = fs_ref.apply_fourstep(x, t.w1, t.w2, t.t)
                    w.add(y, plain / n if inverse else plain,
                          (torch.fft.ifft if inverse else torch.fft.fft)(x),
                          f"n={n} ({t.n1}x{t.n2}) inverse={inverse}")
            rows.append(w)
        for w in rows:
            w.row["check"] = "multi_pass_vs_plain"
            emit(w.row)
            worst[(w.row["kernel"], f"{name} passes")] = w.row
    return worst


def _fold_plain(ops, x, plan, roots, inverse: bool, n: int, fft2: bool):
    """A fold's plain version on the card: ``fft/rfft.py``'s packing
    around the kernel's plain stages (the wrappers' CPU path)."""
    from repro_torch.fft import rfft as rfft_mod
    if fft2:
        m = plan.n1 * plan.n2
        if inverse:
            return rfft_mod.irfftn_packed(
                x, (x.shape[-2], n), lambda z, inverse=False:
                ops.plain(z, plan, True) / m, roots)
        return rfft_mod.rfftn_packed(x, lambda z: ops.plain(z, plan, False),
                                     2, roots)
    if inverse:
        return rfft_mod.irfft(x, n, lambda z, inverse=False:
                              ops.plain(z, plan, True) / plan.n, roots)
    return rfft_mod.rfft(x, lambda z: ops.plain(z, plan, False), roots)


def check_folds(device) -> dict:
    """The one-block kernels' real-input folds on fixed cases (``FOLD_NS``
    and each dtype's fold caps, ``FOLD2_SHAPES``), forward and inverse,
    against their plain versions and ``torch.fft`` at the kernels' bars;
    raises on a miss.  Returns the worst errors per kernel and dtype."""
    import torch
    from repro_torch.fft.reference import half_roots
    gen = torch.Generator(device=device).manual_seed(2024)
    sp, _ = kernel_ops("stockham_pallas")
    f2, _ = kernel_ops("fft2_pallas")
    worst = {}
    for dtype, rdtype in ((torch.complex64, torch.float32),
                          (torch.complex128, torch.float64)):
        name = str(dtype).removeprefix("torch.")
        item = 16 if dtype == torch.complex128 else 8
        cap = sp.ONE_BLOCK_N[dtype]
        odd_cap = max(m for m in range(1, cap + 1, 2) if sp.smooth7(m))
        w = Worst("stockham_pallas", name)
        for n in FOLD_NS + (2 * cap, odd_cap):
            m = n // 2 if n % 2 == 0 else n
            x = torch.randn((CHECK_ROWS, n), dtype=rdtype, device=device,
                            generator=gen)
            fits = sp.smem_bytes(m, 8, item, 2) <= sp.SMEM_LIMIT_BYTES
            for tile in ((1, 8, None) if fits else (1, None)):
                bins = None
                for inverse in (False, True):
                    plan = sp.make_twiddles(m, 8, inverse, dtype, device)
                    roots = half_roots(n, inverse, dtype, device=device) \
                        if n % 2 == 0 else None
                    if inverse:
                        y = sp.irfft(bins, n, tile_b=tile, twiddles=plan,
                                     roots=roots)
                        lib = torch.fft.irfft(bins, n)
                        src = bins
                    else:
                        y = sp.rfft(x, tile_b=tile, twiddles=plan,
                                    roots=roots)
                        lib = torch.fft.rfft(x)
                        src = x
                    torch.cuda.synchronize(device)
                    w.add(y, _fold_plain(sp, src, plan, roots, inverse, n,
                                         False), lib,
                          f"{'irfft' if inverse else 'rfft'} n={n} "
                          f"tile_b={tile}")
                    bins = lib if not inverse else bins
        rows = [w]
        w = Worst("fft2_pallas", name)
        for n1, n2 in FOLD2_SHAPES[name]:
            h = n2 // 2
            x = torch.randn((CHECK_ROWS, n1, n2), dtype=rdtype, device=device,
                            generator=gen)
            fits = f2.smem_bytes(n1 * h, 8, item, 2) <= f2.SMEM_LIMIT_BYTES
            for tile in ((1, 8, None) if fits else (1, None)):
                bins = torch.fft.rfft2(x)
                for inverse in (False, True):
                    plan = f2.make_twiddles2(n1, h, 8, inverse, dtype, device)
                    roots = half_roots(n2, inverse, dtype, device=device)
                    if inverse:
                        y = f2.irfft2(bins, n2, tile_b=tile, twiddles=plan,
                                      roots=roots)
                        lib = torch.fft.irfft2(bins, s=(n1, n2))
                    else:
                        y = f2.rfft2(x, tile_b=tile, twiddles=plan,
                                     roots=roots)
                        lib = bins
                    torch.cuda.synchronize(device)
                    w.add(y, _fold_plain(f2, bins if inverse else x, plan,
                                         roots, inverse, n2, True), lib,
                          f"{'irfft2' if inverse else 'rfft2'} {n1}x{n2} "
                          f"tile_b={tile}")
        rows.append(w)
        for w in rows:
            w.row["check"] = "fold_vs_plain"
            emit(w.row)
            worst[(w.row["kernel"], f"{name} folds")] = w.row
    return worst


class _PackCalls:
    """Counts calls of ``fft/rfft.py``'s separate pack and unpack (its
    rfft, irfft, rfftn_packed, irfftn_packed) while installed."""

    NAMES = ("rfft", "irfft", "rfftn_packed", "irfftn_packed")

    def __init__(self):
        from repro_torch.fft import rfft as rfft_mod
        self.mod, self.calls = rfft_mod, 0
        self.real = {n: getattr(rfft_mod, n) for n in self.NAMES}
        for n, fn in self.real.items():
            setattr(rfft_mod, n, self._counting(fn))

    def _counting(self, fn):
        def call(*args, **kwargs):
            self.calls += 1
            return fn(*args, **kwargs)
        return call

    def close(self) -> None:
        for n, fn in self.real.items():
            setattr(self.mod, n, fn)


def run_backends_nodes(device) -> dict:
    """``Session.run`` of the reference's backends-table nodes that need
    the passes (``BACKENDS_NODES``), each with the launch counts set to 0
    just before it and read just after: each validates and launches its
    own kernel and no other.  Returns per kernel the launches and launch
    shapes."""
    from repro_torch.core.client import Problem, TorchContext
    from repro_torch.core.clients import torch_fft
    from repro_torch.core.suite import Session, SuiteSpec
    from repro_torch.core.tree import BenchNode

    session = Session(TorchContext(device))
    out = {"launches": {}, "shapes": {}}
    for client, extents, kernel in BACKENDS_NODES:
        problem = Problem(extents, "Outplace_Real", "float", 1)
        spec = SuiteSpec(warmups=1, repetitions=3, output=None)
        _reset_counts()
        t0 = time.perf_counter()
        rs = session.run(spec, nodes=[
            BenchNode(getattr(torch_fft, client), problem)])
        counts = _read_counts()
        val = rs.query(op="validate")
        if rs.failures() or len(val) != 1 or not val[0].success:
            raise AssertionError(f"{client} {extents} failed: "
                                 f"{[r.error for r in rs.failures()]}")
        launched = {k: c for k, (c, _) in counts.items() if c}
        if set(launched) != {kernel}:
            raise AssertionError(f"{client} {extents} should launch only "
                                 f"{kernel}, launched {launched}")
        emit({"node": "x".join(map(str, extents)), "client": client,
              "kind": problem.kind, "device": val[0].device,
              "execute_forward_ms": statistics.median(
                  r.time_ms for r in rs.query(op="execute_forward")),
              "launches": launched, "node_s": time.perf_counter() - t0})
        out["launches"][kernel] = counts[kernel][0]
        out["shapes"][kernel] = counts[kernel][1]
    return out


def run_large_paths(device) -> dict:
    """``Session.run`` of the large-N and oddshape paths (``LARGE_PATHS``):
    each node validated, with the launch counts set to 0 just before it
    and read just after, launching its path's kernels and no other.
    Returns the node summaries, and per kernel the launches and launch
    shapes of these paths."""
    import gc

    import torch
    from repro_torch.core.client import TorchContext
    from repro_torch.core.clients import torch_fft
    from repro_torch.core.suite import Session, SuiteSpec
    from repro_torch.core.tree import BenchNode

    session = Session(TorchContext(device))
    out = {"nodes": [], "launches": {}, "shapes": {}}
    spec = SuiteSpec(warmups=1, repetitions=3, plan_cache=True, output=None)
    for client, names, kernels in LARGE_PATHS:
        cls = getattr(torch_fft, client)
        for pname in names:
            problem = _problem(pname)
            _reset_counts()
            t0 = time.perf_counter()
            rs = session.run(spec, nodes=[BenchNode(cls, problem)])
            counts = _read_counts()
            val = rs.query(op="validate")
            if rs.failures() or len(val) != 1 or not val[0].success:
                raise AssertionError(f"{client} {pname} failed: "
                                     f"{[r.error for r in rs.failures()]}")
            launched = {k: c for k, (c, _) in counts.items() if c}
            if set(launched) != set(kernels):
                raise AssertionError(f"{client} {pname} should launch "
                                     f"{sorted(kernels)} and no other, "
                                     f"launched {launched}")
            med = lambda op: statistics.median(
                r.time_ms for r in rs.query(op=op) if r.run >= 0)
            cold = [r.time_ms for r in rs.query(op="init_forward")
                    if r.plan_cache == "miss"]
            node = {"node": pname, "client": client,
                    "extents": "x".join(map(str, problem.extents)),
                    "kind": problem.kind, "precision": problem.precision,
                    "batch": problem.batch, "device": val[0].device,
                    "execute_forward_ms": med("execute_forward"),
                    "execute_inverse_ms": med("execute_inverse"),
                    "init_forward_cold_ms": cold[0] if cold else None,
                    "launches": launched, "node_s": time.perf_counter() - t0}
            emit(node)
            out["nodes"].append(node)
            for k in kernels:
                out["launches"][k] = out["launches"].get(k, 0) + counts[k][0]
                shapes = out["shapes"].setdefault(k, {})
                for key, c in counts[k][1].items():
                    shapes[key] = shapes.get(key, 0) + c
            del rs
            gc.collect()
            torch.cuda.empty_cache()
    emit({"main_path": "six-step, chirp-Z, Bluestein on P10-P14",
          "launches": out["launches"]})
    return out


def run_tables(device) -> None:
    """The ported ``backends`` and ``radix`` tables (the paper's Figs. 6
    and 7): every spec through ``Session.run`` on the card, with the
    launch counts set to 0 just before the tables and read just after.
    Every node its client supports (``backend_supports``) validates; the
    others (the Stockham kernel on 19^3) are failed nodes that ran no
    transform; the tables launch the Stockham, four-step and fft2
    kernels.  Then the entry point ``python -m
    repro_torch.benchmarks.run backends radix`` prints one row for each
    node that ran."""
    from dataclasses import replace

    from repro_torch.benchmarks import table_backends as tb
    from repro_torch.benchmarks import table_radix as tr
    from repro_torch.core.candidates import backend_supports
    from repro_torch.core.client import TorchContext
    from repro_torch.core.suite import Session

    session = Session(TorchContext(device))
    specs = [(f"backend/{tag}", spec) for tag, spec in tb.SPECS.items()]
    specs.append(("radix", tr.SPEC))
    t0 = time.perf_counter()
    _reset_counts()
    ran = 0
    for name, spec in specs:
        spec = replace(spec, repetitions=3)
        rs = session.run(spec)
        for node in spec.build_nodes():
            cls, problem = node.client_cls, node.problem
            ext = "x".join(map(str, problem.extents))
            want = cls.backend_filter is None or backend_supports(
                cls.backend_filter, problem)
            val = rs.query(op="validate", library=cls.title, extents=ext)
            fwd = rs.query(op="execute_forward", library=cls.title,
                           extents=ext)
            if len(val) != 1 or val[0].success != want or bool(fwd) != want:
                raise AssertionError(
                    f"table {name}: {cls.title} {ext} should "
                    f"{'validate' if want else 'be a failed node'}: "
                    f"{[(r.success, r.error) for r in val]}")
            ran += want
    launched = _counts()
    emit({"tables": "backends radix", "nodes_ran": ran,
          "launches": launched, "tables_s": time.perf_counter() - t0})
    missing = [k for k in ("stockham_pallas", "fft4step", "fft2_pallas")
               if not launched[k]]
    if missing:
        raise AssertionError(f"the tables did not launch {missing}")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "backends",
         "radix"], cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC),
        capture_output=True, text=True, timeout=600)
    rows = [line for line in out.stdout.splitlines()
            if line.startswith(("backend/", "radix/"))]
    emit({"tables_cli_rc": out.returncode, "rows": len(rows),
          "cli_s": time.perf_counter() - t0})
    if out.returncode != 0 or len(rows) != ran:
        raise AssertionError(f"run backends radix: rc {out.returncode}, "
                             f"{len(rows)} rows for {ran} nodes: "
                             f"{out.stderr[-2000:]}")


class _NodeLaunches:
    """While installed, sets the launch counts and ``fft/rfft.py``'s call
    count to 0 just before each node ``run_nodes`` runs and reads them
    just after; ``nodes`` holds one record per node."""

    def __init__(self, pack: _PackCalls):
        from repro_torch.core import benchmark
        self.mod, self.real, self.pack = benchmark, benchmark.run_node, pack
        self.nodes: list[dict] = []
        benchmark.run_node = self._run

    def _run(self, node, **kwargs) -> None:
        _reset_counts()
        self.pack.calls = 0
        self.real(node, **kwargs)
        counts = _read_counts()
        self.nodes.append({
            "path": node.path, "client": node.client_cls.title,
            "launches": {k: c for k, (c, _) in counts.items() if c},
            "folds": sorted({key[0] for _, shapes in counts.values()
                             for key in shapes if isinstance(key[0], str)}),
            "rfft_py_calls": self.pack.calls})

    def close(self) -> None:
        self.mod.run_node = self.real


def _read_result_file(path: str) -> tuple[list, list[dict]]:
    """A CLI result file's columns and rows (CSV, or JSONL by extension)."""
    import csv
    with open(path, newline="") as f:
        if path.endswith(".jsonl"):
            rows = [json.loads(line) for line in f]
            return (list(rows[0]) if rows else []), rows
        reader = csv.DictReader(f)
        return list(reader.fieldnames or []), list(reader)


def _cli_call(argv, session, hook) -> tuple[int, str]:
    """``repro_torch.core.cli.main(argv, session=...)`` with its stdout
    captured."""
    import contextlib
    import io

    from repro_torch.core import cli
    hook.nodes.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, session=session)
    return rc, buf.getvalue()


def _check_cli_run(name: str, argv, kernels: dict, hook) -> list[dict]:
    """The run's file holds the reference's columns and one successful
    validate row per node of the spec's tree; each node launched its
    client's kernels and no other (a fold node: its folds, and none of
    ``fft/rfft.py``'s packing).  Returns the node summaries."""
    from repro_torch.core import cli
    from repro_torch.core.results import columns_for

    spec = cli.spec_from_args(cli.build_parser().parse_args(argv))
    want_paths = [n.path for n in spec.build_nodes()]
    if [n["path"] for n in hook.nodes] != want_paths:
        raise AssertionError(f"CLI {name} ran {[n['path'] for n in hook.nodes]}"
                             f", the spec's tree is {want_paths}")
    columns, rows = _read_result_file(spec.output)
    if columns != columns_for(spec.plan_cache,
                              plan_source=spec.wisdom is not None):
        raise AssertionError(f"CLI {name}: columns {columns}")
    val = [r for r in rows if r["op"] == "validate"]
    if len(val) != len(want_paths) \
            or not all(r["success"] in (True, "True") for r in val):
        raise AssertionError(f"CLI {name}: validate rows "
                             f"{[(r['library'], r['error']) for r in val]}")
    out = []
    for node in hook.nodes:
        client = node["client"]
        if set(node["launches"]) != set(kernels[client]):
            raise AssertionError(f"CLI {name} {node['path']} should launch "
                                 f"{kernels[client]} and no other, launched "
                                 f"{node['launches']}")
        fold = FOLD_NODES.get((client, name))
        if fold is not None and (node["folds"] != sorted(fold)
                                 or node["rfft_py_calls"]):
            raise AssertionError(f"CLI {name} {node['path']} should run "
                                 f"through {fold}: {node}")
        fwd = [float(r["time_ms"]) for r in rows
               if r["op"] == "execute_forward" and r["library"] == client
               and int(r["run"]) >= 0]
        out.append({"cli": name, **node,
                    "execute_forward_ms": statistics.median(fwd)})
    return out


def run_cli(device) -> None:
    """The CLI at the main path's full sizes (``CLI_RUNS``), in process on
    a ``cuda:0`` session with the launch counts read per node; a ``-r``
    selection (``CLI_SELECT``); ``--dump-config`` on P3, whose file
    ``python -m repro_torch.core.cli --config`` then replays at one
    repetition: the same spec and tree, the same columns, every node
    validated."""
    from repro_torch.core import cli
    from repro_torch.core.client import TorchContext
    from repro_torch.core.clients import torch_fft
    from repro_torch.core.suite import Session, SuiteSpec
    from repro_torch.core.tree import build_tree, select

    session = Session(TorchContext(device))
    pack = _PackCalls()
    hook = _NodeLaunches(pack)
    try:
        for name, argv, kernels in CLI_RUNS:
            t0 = time.perf_counter()
            rc, text = _cli_call(argv, session, hook)
            if rc != 0:
                raise AssertionError(f"CLI {name} returned {rc}: {text}")
            for node in _check_cli_run(name, argv, kernels, hook):
                emit(node)
            emit({"cli": name, "stdout": text.splitlines(),
                  "cli_s": time.perf_counter() - t0})

        argv, kernels = CLI_SELECT
        rc, text = _cli_call(argv, session, hook)
        spec = cli.spec_from_args(cli.build_parser().parse_args(argv))
        tree = build_tree([getattr(torch_fft, c) for c in spec.clients],
                          spec.extents, kinds=spec.kinds,
                          precisions=spec.precisions, batch=spec.batch)
        want = [n.path for n in select(tree, spec.select)]
        if rc != 0 or len(want) != 1 or len(tree) != 4:
            raise AssertionError(f"CLI selection: rc {rc}, {want}: {text}")
        nodes = _check_cli_run("select", argv, kernels, hook)
        if [n["path"] for n in nodes] != want:
            raise AssertionError(f"CLI selection ran {nodes}, tree.select "
                                 f"gives {want}")
        emit({"cli": "select", "pattern": spec.select,
              "tree": len(tree), "ran": [n["path"] for n in nodes]})

        p3 = CLI_RUNS[1][1]
        toml = os.path.join(CLI_DIR, "p3.toml")
        rc, _ = _cli_call(p3 + ["--dump-config", toml], session, hook)
        replayed = SuiteSpec.from_file(toml)
        direct = cli.spec_from_args(cli.build_parser().parse_args(p3))
        if rc != 0 or hook.nodes or replayed != direct \
                or replayed.build_nodes() != direct.build_nodes():
            raise AssertionError(f"--dump-config P3: rc {rc}, {replayed} != "
                                 f"{direct}")
    finally:
        hook.close()
        pack.close()

    # the replay runs as a program: P3's spec file at one repetition
    t0 = time.perf_counter()
    replay = os.path.join(CLI_DIR, "p3b.csv")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.cli", "--config", toml,
         "-o", replay, "--reps", "1"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
        timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"python -m repro_torch.core.cli: rc "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    columns, rows = _read_result_file(replay)
    val = [r for r in rows if r["op"] == "validate"]
    if columns != _read_result_file(direct.output)[0] \
            or [r["library"] for r in val] != list(direct.clients) \
            or not all(r["success"] == "True" for r in val) \
            or {r["run"] for r in rows if r["op"] == "execute_forward"} \
            != {"0"}:
        raise AssertionError(f"the replayed P3 program: columns {columns}, "
                             f"validate rows {val}")
    emit({"cli": "P3 replayed as a program", "config":
          os.path.relpath(toml, ROOT), "rc": out.returncode,
          "rows": len(rows), "stdout": out.stdout.splitlines(),
          "program_s": time.perf_counter() - t0})


def run_paper_tables(device) -> None:
    """The paper's ``overhead``, ``tts``, ``plan_rigor`` and ``dtypes``
    tables (``PAPER_TABLES``) through ``Session.run`` on the card, their
    rows emitted as CSV: every node its client supports validates.  Then
    their entry point ``python -m repro_torch.benchmarks.run ...`` prints
    the same row names."""
    import contextlib
    import importlib
    import io

    from repro_torch.core.candidates import backend_supports
    from repro_torch.core.client import TorchContext
    from repro_torch.core.suite import Session

    class Recording(Session):
        def __init__(self, context):
            super().__init__(context)
            self.runs = []

        def run(self, spec, nodes=None):
            rs = super().run(spec, nodes)
            self.runs.append((spec, rs))
            return rs

    session = Recording(TorchContext(device))
    names = []
    t0 = time.perf_counter()
    _reset_counts()
    hook = _PlanPicks()
    try:
        for table in PAPER_TABLES:
            mod = importlib.import_module(
                f"repro_torch.benchmarks.table_{table}")
            buf = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mod.run(session=session)
            lines = buf.getvalue().splitlines()
            emit({"table": table, "csv": lines,
                  "table_s": time.perf_counter() - t1})
            names += [line.split(",")[0] for line in lines]
    finally:
        hook.close()
    # Figs. 4-5: TorchPlanned's pick at every init (each repetition
    # re-plans), and whether MEASURE's and WISDOM_ONLY's are the same
    picks = _rigor_picks(hook.picks)
    for (rigor, problem), keys in sorted(picks.items()):
        emit({"plan_rigor_picks": problem, "rigor": rigor, "picks": keys})
    for problem in sorted({p for r, p in picks if r == "measure"}):
        measure = sorted(set(picks[("measure", problem)]))
        wisdom = sorted(set(picks.get(("wisdom_only", problem), [])))
        emit({"measure_vs_wisdom_only": problem,
              "same_pick": measure == wisdom, "measure": measure,
              "wisdom_only": wisdom})
    if not any(n.startswith("fft_time/estimate_fitted/") for n in names):
        raise AssertionError("plan_rigor emitted no estimate_fitted rows, "
                             "with the fitted H100 table committed")
    ran = 0
    for spec, rs in session.runs:
        for node in spec.build_nodes():
            cls, problem = node.client_cls, node.problem
            want = cls.backend_filter is None or backend_supports(
                cls.backend_filter, problem)
            val = rs.query(op="validate", library=cls.title,
                           extents="x".join(map(str, problem.extents)),
                           kind=problem.kind, precision=problem.precision)
            if len(val) != 1 or val[0].success != want:
                raise AssertionError(
                    f"table spec {spec.rigor} {node.path} should "
                    f"{'validate' if want else 'be a failed node'}: "
                    f"{[(r.success, r.error) for r in val]}")
            ran += want
    emit({"tables": " ".join(PAPER_TABLES), "runs": len(session.runs),
          "nodes_ran": ran, "rows": len(names), "launches": _counts(),
          "tables_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", *PAPER_TABLES],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=600)
    rows = [line.split(",")[0] for line in out.stdout.splitlines()[1:]]
    emit({"tables_cli_rc": out.returncode, "rows": len(rows),
          "cli_s": time.perf_counter() - t0})
    if out.returncode != 0 or sorted(rows) != sorted(names):
        raise AssertionError(f"run {' '.join(PAPER_TABLES)}: rc "
                             f"{out.returncode}, rows {sorted(rows)} against "
                             f"{sorted(names)}: {out.stderr[-2000:]}")


class _PlanPicks:
    """While installed, records each client's plan selection
    (``TorchFFTClient._select``): one record per init of a client, so per
    repetition where no plan cache holds the pick."""

    def __init__(self):
        from repro_torch.core.clients import torch_fft
        self.cls = torch_fft.TorchFFTClient
        self.real = self.cls._select
        self.picks: list[dict] = []
        real, picks = self.real, self.picks

        def _select(client):
            cand = real(client)
            picks.append({"client": client.title,
                          "rigor": client.rigor.value,
                          "problem": client.problem.signature(),
                          "pick": cand.key() if cand is not None else None,
                          "source": client.plan_source})
            return cand

        self.cls._select = _select

    def close(self) -> None:
        self.cls._select = self.real


def _rigor_picks(picks: list[dict]) -> dict:
    """``TorchPlanned``'s pick keys per (rigor, problem), in order."""
    out: dict = {}
    for p in picks:
        if p["client"] == "TorchPlanned":
            out.setdefault((p["rigor"], p["problem"]), []).append(p["pick"])
    return out


def check_smoke_grid(device) -> None:
    """The bench grid's smoke mode on the card (``SMOKE_EXTENTS`` x
    ``DEFAULT_BACKENDS``, 1 repetition) into ``build/trajectory/``, read
    back with the port's ``load_bench``: every row the support rules admit
    is ok and launched its backend's kernels and no other (read per row by
    wrapping ``bench_backend``), every other row is the reference's
    unsupported row."""
    import contextlib
    import io

    from repro_torch.benchmarks import bench_grid
    from repro_torch.core.candidates import Candidate, backend_supports
    from repro_torch.core.client import Problem
    from repro_torch.core.compare import load_bench
    from repro_torch.core.extents import parse_extents

    os.makedirs(TRAJECTORY_DIR, exist_ok=True)
    out = os.path.join(TRAJECTORY_DIR, "BENCH_smoke_cuda.json")
    report = os.path.join(TRAJECTORY_DIR, "fig7_smoke_cuda.md")
    real, launched = bench_grid.bench_backend, {}

    def counted(backend, extents, *args, **kwargs):
        _reset_counts()
        rec = real(backend, extents, *args, **kwargs)
        launched[(backend, rec["extent"])] = {
            k: c for k, c in _counts().items() if c}
        return rec

    bench_grid.bench_backend = counted
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = bench_grid.main(["--smoke", "--device", str(device),
                                  "--out", out, "--report", report])
    finally:
        bench_grid.bench_backend = real
    doc = load_bench(out)
    if rc != 0 or len(doc.rows) != len(bench_grid.SMOKE_EXTENTS) * len(
            bench_grid.DEFAULT_BACKENDS):
        raise AssertionError(f"smoke grid: rc {rc}, {len(doc.rows)} rows: "
                             f"{buf.getvalue()[-2000:]}")
    ran = 0
    for row in doc.rows:
        problem = Problem(parse_extents(row["extent"]), row["kind"],
                          row["precision"], row["batch"])
        key = (row["backend"], row["extent"])
        if not backend_supports(row["backend"], problem):
            if row["ok"] or row.get("error") != "unsupported extents/rank":
                raise AssertionError(f"smoke grid {key}: should be the "
                                     f"unsupported row: {row}")
            continue
        want = _kernels_of(Candidate(row["backend"]), problem)
        if not row["ok"] or set(launched[key]) != want:
            raise AssertionError(f"smoke grid {key}: ok {row['ok']} "
                                 f"({row.get('error')}), launched "
                                 f"{launched[key]}, its kernels {sorted(want)}")
        ran += 1
    emit({"smoke_grid": os.path.relpath(out, ROOT), "rows": len(doc.rows),
          "ran": ran, "launches": {f"{b}/{e}": c for (b, e), c
                                   in launched.items() if c},
          "fig7": open(report).read().splitlines(),
          "smoke_grid_s": time.perf_counter() - t0})


def check_bench_h100() -> None:
    """The committed H100 grid (``BENCH_h100.json``): no row of at least
    ``LARGE_ROW_BYTES`` each way moves its signal faster than 1.05 x one
    HBM read and write (a faster one is a timing fault); the rows whose
    ``roofline_frac`` reads over 1 (where the hand-written model charges
    more passes than the card makes) are printed."""
    from repro_torch.core.compare import load_bench

    doc = load_bench(os.path.join(BASELINES, "BENCH_h100.json"))
    limit = 1.05 * HBM_BYTES_PER_S / 2**30
    large = []
    for row in doc.ok_rows():
        n = row["batch"] * math.prod(int(v) for v in
                                     row["extent"].split("x"))
        if n * 8 >= LARGE_ROW_BYTES:
            large.append(f"{row['backend']}/{row['extent']}")
            if row["gib_per_s"] > limit:
                raise AssertionError(
                    f"BENCH_h100 {row['backend']}/{row['extent']}: "
                    f"{row['gib_per_s']:.1f} GiB/s over 1.05 x HBM "
                    f"({limit:.1f} GiB/s): a timing fault")
    over = [{"row": f"{r['backend']}/{r['extent']}", "time_ms": r["time_ms"],
             "model_bytes": r["model_bytes"],
             "roofline_frac": r["roofline_frac"]}
            for r in doc.ok_rows() if r["roofline_frac"] > 1.0]
    emit({"bench_h100": doc.meta.get("device_kind"),
          "power_limit": doc.meta.get("power_limit"),
          "large_rows": large, "gib_per_s_limit": limit,
          "roofline_frac_over_1": over})


def check_fitted_estimate(device) -> None:
    """ESTIMATE under the fitted H100 table (``costmodel_h100.json``,
    installed through ``SuiteSpec.costmodel``) on P1-P14: each fitted pick
    beside the hand-written one (``ESTIMATE_PICKS``) and MEASURE's (the
    planner phase's wisdom); every node whose fitted pick differs runs
    through ``Session.run``, validates, selects the fitted pick and
    launches its kernels and no other."""
    import torch

    from repro_torch.core.candidates import Candidate
    from repro_torch.core.client import TorchContext
    from repro_torch.core.clients.torch_fft import TorchPlanned
    from repro_torch.core.costmodel import (DEFAULT_MODEL, model_for_device,
                                            use_model)
    from repro_torch.core.plan import PlanRigor, make_plan
    from repro_torch.core.suite import Session, SuiteSpec
    from repro_torch.core.tree import BenchNode
    from repro_torch.core.wisdom import Wisdom

    table = os.path.join(BASELINES, "costmodel_h100.json")
    kind = torch.cuda.get_device_name(0)
    fitted = model_for_device(kind, table)
    if fitted is DEFAULT_MODEL:
        raise AssertionError(f"{table} has no table for {kind!r}")
    measured = Wisdom(WISDOM_PATH, device_kind=kind)
    changed = []
    for pname, hand in ESTIMATE_PICKS.items():
        problem = _problem(pname)
        with use_model(fitted):
            pick = make_plan(problem, PlanRigor.ESTIMATE).candidate.key()
        m = measured.lookup(problem)
        emit({"fitted_estimate": pname, "pick": pick, "hand_written": hand,
              "measure": m.key() if m is not None else "not measured"})
        if pick != hand:
            changed.append((pname, pick))
    session = Session(TorchContext(device))
    hook = _PlanPicks()
    try:
        for pname, pick in changed:
            problem = _problem(pname)
            # no plan cache: every repetition plans under the fitted table
            spec = SuiteSpec(rigor="estimate", costmodel=table, warmups=1,
                             repetitions=2, plan_cache=False, output=None)
            hook.picks.clear()
            _reset_counts()
            rs = session.run(spec, nodes=[BenchNode(TorchPlanned, problem)])
            launches = {k: c for k, c in _counts().items() if c}
            val = rs.query(op="validate")
            picks = {p["pick"] for p in hook.picks}
            want = _kernels_of(Candidate.from_key(pick), problem)
            if len(val) != 1 or not val[0].success or picks != {pick} \
                    or set(launches) != want:
                raise AssertionError(
                    f"fitted ESTIMATE {pname}: validate "
                    f"{[(r.success, r.error) for r in val]}, selected "
                    f"{picks} (fitted {pick}), launched {launches}, its "
                    f"kernels {sorted(want)}")
            emit({"fitted_node": pname, "pick": pick,
                  "hand_written": ESTIMATE_PICKS[pname],
                  "execute_forward_ms": statistics.median(
                      r.time_ms for r in rs.query(op="execute_forward")
                      if r.run >= 0),
                  "launches": launches})
    finally:
        hook.close()


def run_trajectory(device) -> None:
    """The perf-trajectory phase: the smoke grid on the card, the
    committed H100 grid's bounds, and ESTIMATE under the fitted table."""
    check_smoke_grid(device)
    check_bench_h100()
    check_fitted_estimate(device)


def _conv_inputs(device, gen, c, b, L, K):
    import torch
    x = torch.randn((c, b, L), device=device, generator=gen)
    h = torch.randn((c, K), device=device, generator=gen) / math.sqrt(K)
    return x, h


def _conv_errors(ops, ref, x, h, tile_b):
    """One launch of the fftconv kernel against its plain version on the
    same operands and against the float64 oracle: (rel-L2 plain, rel-L2
    oracle, max abs error against plain)."""
    import torch
    op = ops.prepare(x, h, tile_b=tile_b)
    y = ops.run_kernel(op)
    plain = op.plain()
    torch.cuda.synchronize(x.device)
    oracle = ref.fftconv_ref(x.double(), h.double(), op.n)
    return (rel_l2(y, plain), rel_l2(y.double(), oracle),
            float((y - plain).abs().max()))


def check_fftconv(device) -> dict:
    """The fftconv kernel on fixed cases against its plain version and the
    float64 oracle (both within ``CONV_TOL``); raises on a miss.  Returns
    the worst errors."""
    import torch
    ops, ref = kernel_ops("fftconv")
    gen = torch.Generator(device=device).manual_seed(2023)
    row = {"check": "kernel_vs_plain", "kernel": "fftconv",
           "dtype": "float32", "cases": 0, "rel_l2_plain": 0.0,
           "rel_l2_oracle": 0.0, "max_abs_err": 0.0}
    cases = []
    for k in CONV_KS:
        n = k * k
        tiles = range(1, ops.largest_tile_b(n) + 1)
        for c, b in CONV_CB:
            for L, K in ((n, 1), ((n + 1) // 2, (n + 1) // 2)):
                cases += [(c, b, L, K, t) for t in tiles]
    cases += [(*case, None) for case in CONV_REFERENCE_CASES]
    for c, b, L, K, tile in cases:
        x, h = _conv_inputs(device, gen, c, b, L, K)
        e_plain, e_oracle, err = _conv_errors(ops, ref, x, h, tile)
        if not (e_plain <= CONV_TOL and e_oracle <= CONV_TOL):
            raise AssertionError(
                f"fftconv kernel disagrees: C={c} B={b} L={L} K={K} "
                f"tile_b={tile}: rel_l2 vs plain {e_plain:.3e}, vs the "
                f"float64 oracle {e_oracle:.3e}")
        row["cases"] += 1
        row["rel_l2_plain"] = max(row["rel_l2_plain"], e_plain)
        row["rel_l2_oracle"] = max(row["rel_l2_oracle"], e_oracle)
        row["max_abs_err"] = max(row["max_abs_err"], err)
    emit(row)
    return row


def _recording(cls):
    """``cls`` (its title inherited) keeping its last download."""
    class Recording(cls):
        last = None

        def download(self):
            out = super().download()
            Recording.last = out
            return out
    return Recording


def _table_node(session, cls, problem, spec) -> tuple[dict, object]:
    """``Session.run`` of one kernel-table client: the node validated,
    launching its client's kernel and no other.  Returns the node's
    summary and its download."""
    from repro_torch.core.tree import BenchNode
    rec = _recording(cls)
    before = _counts()
    t0 = time.perf_counter()
    rs = session.run(spec, nodes=[BenchNode(rec, problem)])
    node_s = time.perf_counter() - t0
    launched = {k: c - before[k] for k, c in _counts().items()
                if c != before[k]}
    title = cls.title
    val = rs.query(op="validate")
    if rs.failures() or len(val) != 1 or not val[0].success:
        raise AssertionError(f"{title} {problem.extents} failed: "
                             f"{[r.error for r in rs.failures()]}")
    want = TABLE_KERNEL[title]
    if set(launched) != ({want} if want else set()):
        raise AssertionError(f"{title} should launch {want}, launched "
                             f"{launched}")
    node = {"client": title, "extents": "x".join(map(str, problem.extents)),
            "batch": problem.batch, "device": val[0].device,
            "execute_forward_ms": statistics.median(
                r.time_ms for r in rs.query(op="execute_forward")),
            "launches": launched, "node_s": node_s}
    return node, rec.last


def _agree(a, b, what: str, device) -> float:
    import torch
    e = rel_l2(torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))
    if not e <= CONV_TOL:
        raise AssertionError(f"{what}: rel_l2 {e:.3e} > {CONV_TOL}")
    return e


def run_fftconv_path(device) -> dict:
    """The fftconv kernel's main path, with the launch counts set to 0
    just before it and read just after: the port's kernel table at the
    reference's sizes (``Session.run`` of every spec; each kernel client's
    download against its plain counterpart at ``CONV_TOL``), then the
    fused and unfused fftconv clients at F2 and F3 (the fused download
    against the unfused one).  Returns per kernel the launches and launch
    shapes of the path."""
    from dataclasses import replace

    from repro_torch.benchmarks import table_kernels as tk
    from repro_torch.core.client import Problem, TorchContext
    from repro_torch.core.suite import Session, SuiteSpec

    session = Session(TorchContext(device))
    _reset_counts()
    for spec in tk.SPECS:
        spec = replace(spec, repetitions=3)
        outs = {}
        for node in spec.build_nodes():
            row, outs[node.client_cls.title] = _table_node(
                session, node.client_cls, node.problem, spec)
            row["table"] = tk.NAMES[row["client"]]
            emit(row)
        for kernel, plain in TABLE_PAIRS:
            if kernel in outs:
                a, b = outs[kernel], outs[plain]
                if kernel == "KernelFftconvFused":   # (1, L, C*B) -> (C, B, L)
                    b = b.reshape(a.shape[-1], -1).T.reshape(a.shape)
                emit({"check": "table_pair", "kernel_client": kernel,
                      "plain_client": plain,
                      "rel_l2": _agree(a, b, f"{kernel} vs {plain}",
                                       device)})
    spec = SuiteSpec(warmups=1, repetitions=3, plan_cache=False, output=None)
    for name, c, b, L in CONV_WIDTHS:
        widths = {"channels": c, "signals": b, "taps": L}
        problem = Problem((L,), "Outplace_Real", "float", 1)
        outs = {}
        for cls in (tk.FftconvFusedKernel, tk.FftconvUnfusedKernel):
            row, outs[cls.title] = _table_node(
                session, type(cls.__name__, (cls,), widths), problem, spec)
            emit({"node": name, **widths, **row})
        fused, unfused = outs["KernelFftconvFused"], outs["KernelFftconvUnfused"]
        emit({"check": "fused_vs_unfused", "node": name,
              "rel_l2": _agree(fused, unfused.reshape(L, -1).T.reshape(
                  fused.shape), f"{name} fused vs unfused", device)})
        del outs, fused, unfused
    counts = _read_counts()
    emit({"main_path": "kernel table + fftconv F2/F3",
          "launches": {k: c for k, (c, _) in counts.items()}})
    if counts["fftconv"][0] <= 0:
        raise AssertionError("the fftconv path did not launch fftconv")
    return {"launches": {k: c for k, (c, _) in counts.items()},
            "shapes": {k: shapes for k, (c, shapes) in counts.items() if c}}


def _reset_counts() -> None:
    for kernel, _, _ in KERNELS:
        ops, _ = kernel_ops(kernel)
        ops.LAUNCHES = 0
        ops.LAUNCH_SHAPES.clear()


def _read_counts() -> dict:
    counts = {}
    for kernel, _, _ in KERNELS:
        ops, _ = kernel_ops(kernel)
        counts[kernel] = (ops.LAUNCHES, dict(ops.LAUNCH_SHAPES))
    return counts


def run_main_path(device) -> dict:
    """Session.run of each client on its problems; each path runs with the
    launch counts set to 0 just before it and read just after.  Returns the
    per-node summaries, and per kernel the launches and launch shapes of
    its own client's path."""
    from repro_torch.core.client import TorchContext
    from repro_torch.core.suite import Session

    session = Session(TorchContext(device))
    problems = {p[0]: p[1:] for p in PROBLEMS}
    summary = {"nodes": [], "launches": {}, "shapes": {}}
    pack = _PackCalls()
    try:
        _run_paths(session, problems, summary, pack)
    finally:
        pack.close()
    return summary


def _run_paths(session, problems, summary, pack) -> None:
    from repro_torch.core.clients import torch_fft
    from repro_torch.core.suite import SuiteSpec
    from repro_torch.core.tree import build_tree

    for client, names, kernel in PATHS:
        cls = getattr(torch_fft, client)
        _reset_counts()
        node_launches = []
        for pname in names:
            extents, kind, precision, batch = problems[pname]
            spec = SuiteSpec(clients=(client,), extents=(extents,),
                             kinds=(kind,), precisions=(precision,),
                             batch=batch, warmups=1, repetitions=3,
                             plan_cache=True, output=None)
            nodes = build_tree([cls], [extents], kinds=(kind,),
                               precisions=(precision,), batch=batch)
            n0 = sum(c for c, _ in _read_counts().values())
            shapes0 = {k: dict(sh) for k, (_, sh) in _read_counts().items()}
            pack.calls = 0
            t0 = time.perf_counter()
            rs = session.run(spec, nodes=nodes)
            if rs.failures():
                raise AssertionError(f"{client} {pname} failed: "
                                     f"{[r.error for r in rs.failures()]}")
            val = rs.query(op="validate")
            if len(val) != 1 or not val[0].success:
                raise AssertionError(f"{client} {pname}: no successful validate row")
            med = lambda op: statistics.median(
                r.time_ms for r in rs.query(op=op) if r.run >= 0)
            cold = [r.time_ms for r in rs.query(op="init_forward")
                    if r.plan_cache == "miss"]
            transforms = 2 * (spec.warmups + spec.repetitions)
            launched = sum(c for c, _ in _read_counts().values()) - n0
            folds = sorted({key[0] for key, c in _read_counts()[kernel][1]
                            .items() if isinstance(key[0], str)
                            and c > shapes0[kernel].get(key, 0)}) \
                if kernel else []
            want = FOLD_NODES.get((client, pname))
            if want is not None and (folds != sorted(want) or pack.calls):
                raise AssertionError(
                    f"{client} {pname} should run its real kind through "
                    f"{want} and none of rfft.py's packing: launched folds "
                    f"{folds}, rfft.py calls {pack.calls}")
            node = {"node": pname, "client": client,
                    "path": nodes[0].path, "device": val[0].device,
                    "execute_forward_ms": med("execute_forward"),
                    "execute_inverse_ms": med("execute_inverse"),
                    "init_forward_ms": med("init_forward"),
                    "init_forward_cold_ms": cold[0] if cold else None,
                    "kernel_launches_per_transform": launched / transforms,
                    "folds": folds, "rfft_py_calls": pack.calls,
                    "node_s": time.perf_counter() - t0}
            emit(node)
            summary["nodes"].append(node)
            node_launches.append(launched)
        counts = _read_counts()
        emit({"main_path": client, "launches": {k: c for k, (c, _) in
                                                counts.items()}})
        others = {k: c for k, (c, _) in counts.items() if k != kernel and c}
        if others:
            raise AssertionError(f"{client} launched other kernels: {others}")
        if kernel is not None:
            launches, shapes = counts[kernel]
            if launches <= 0 or not all(node_launches):
                raise AssertionError(f"{client} did not launch {kernel} on "
                                     f"every node: {node_launches}")
            summary["launches"][kernel] = launches
            summary["shapes"][kernel] = shapes


def check_failed_node(device) -> None:
    """TorchFft2Pallas on P1 (rank 3) is a failed node that launched no
    kernel and ran no transform."""
    from repro_torch.core.client import Problem, TorchContext
    from repro_torch.core.clients.torch_fft import TorchFft2Pallas
    from repro_torch.core.suite import Session, SuiteSpec
    from repro_torch.core.tree import BenchNode

    _, extents, kind, precision, batch = PROBLEMS[0]
    _reset_counts()
    rs = Session(TorchContext(device)).run(
        SuiteSpec(output=None, warmups=1, repetitions=3),
        nodes=[BenchNode(TorchFft2Pallas,
                         Problem(extents, kind, precision, batch))])
    launched = {k: c for k, (c, _) in _read_counts().items() if c}
    fails = rs.failures()
    if (len(fails) != 1 or fails[0].op != "validate"
            or "rank-2 only" not in fails[0].error
            or rs.query(op="execute_forward") or launched):
        raise AssertionError(f"TorchFft2Pallas on P1 is not a clean failed "
                             f"node: {[(r.op, r.error) for r in fails]}, "
                             f"launches {launched}")
    emit({"check": "failed_node", "client": "TorchFft2Pallas", "node": "P1",
          "error": fails[0].error})


def _problem(pname: str):
    from repro_torch.core.client import Problem
    _, extents, kind, precision, batch = next(
        p for p in PROBLEMS + PATIENT_PROBLEMS if p[0] == pname)
    return Problem(extents, kind, precision, batch)


def _kernels_of(cand, problem) -> set:
    """The kernels a plan runs on ``problem`` (none for torch.fft and the
    baselines): a six-step axis the Stockham and four-step kernels (the
    Stockham kernel alone below n = 4), a chirp-Z axis its padded
    engine's as the card resolves it."""
    from repro_torch.core.candidates import axis_engine_n
    from repro_torch.fft.bluestein import resolve_engine
    out = set()
    for i, a in enumerate(cand.per_axis(problem.rank)):
        n, backend = axis_engine_n(problem, i), a.backend
        if backend == "chirpz_pallas" and n > 1:
            backend = resolve_engine(n, a.opts().get("engine", "auto"))[0]
        if backend == "sixstep":
            out |= {"stockham_pallas", "fft4step"} if n >= 4 \
                else {"stockham_pallas"}
        elif backend in BACKEND_KERNEL:
            out.add(BACKEND_KERNEL[backend])
    return out


def _counts() -> dict:
    return {k: c for k, (c, _) in _read_counts().items()}


def _launch_shapes() -> dict:
    """Per kernel, the shapes launched since the counts were last set to
    0."""
    return {k: shapes for k, (c, shapes) in _read_counts().items() if c}


def check_candidates(device, pname: str, cands) -> dict:
    """Every candidate's forward, as MEASURE builds and runs it on MEASURE's
    own input, against the ``xla`` (torch.fft) candidate's within
    ``LIBRARY_TOL``: a wrong but fast plan could otherwise win a sweep and
    be replayed from wisdom.  Raises on a miss."""
    import torch
    from repro_torch.core.candidates import Candidate
    from repro_torch.core.clients.torch_fft import _forward_fn
    from repro_torch.core.plan import measure_input

    problem = _problem(pname)
    dname = "complex64" if problem.precision == "float" else "complex128"
    x = measure_input(problem, device)
    want = _forward_fn(problem, Candidate("xla"), device)(x)
    worst, checked = 0.0, 0
    for cand in cands:
        if cand.key() == "xla":
            continue
        y = _forward_fn(problem, cand, device)(x)
        torch.cuda.synchronize(device)
        e = rel_l2(y, want)
        if not (y.shape == want.shape and e <= LIBRARY_TOL[dname]):
            raise AssertionError(
                f"{pname} candidate {cand.key()} disagrees with torch.fft: "
                f"shape {tuple(y.shape)}, rel_l2 {e:.3e}")
        worst, checked = max(worst, e), checked + 1
        del y
    row = {"check": "candidates_vs_torch_fft", "node": pname,
           "candidates": checked, "rel_l2_library": worst}
    emit(row)
    del x, want
    torch.cuda.empty_cache()
    return row


def _planned_node(session, pname: str, rigor: str,
                  wisdom: str | None = None, client: str = "TorchPlanned"
                  ) -> dict:
    """``Session.run`` of a planning client (``TorchPlanned``, or a client
    pinned to one backend) on one problem under ``rigor``: every node
    valid; returns the node's summary with its plan and the kernel
    launches of its run."""
    from repro_torch.core.clients import torch_fft
    from repro_torch.core.plan import PlanCache, PlanRigor
    from repro_torch.core.suite import SuiteSpec
    from repro_torch.core.tree import BenchNode

    cls = getattr(torch_fft, client)
    problem = _problem(pname)
    spec = SuiteSpec(rigor=rigor, wisdom=wisdom, warmups=1, repetitions=3,
                     plan_cache=True, output=None)
    before = _counts()
    t0 = time.perf_counter()
    rs = session.run(spec, nodes=[BenchNode(cls, problem)])
    node_s = time.perf_counter() - t0
    launched = {k: c - before[k] for k, c in _counts().items()}
    if rs.failures():
        raise AssertionError(f"{client} {rigor} {pname} failed: "
                             f"{[r.error for r in rs.failures()]}")
    val = rs.query(op="validate")
    if len(val) != 1 or not val[0].success:
        raise AssertionError(f"{client} {rigor} {pname}: no successful "
                             "validate row")
    plan, event = session.plan_cache.plan(
        PlanCache.plan_key(session.device_kind, problem, PlanRigor(rigor),
                           scope=cls.backend_filter or "*"), lambda: None)
    if event != "hit" or plan is None:
        raise AssertionError(f"{client} {rigor} {pname}: no plan")
    med = lambda op: statistics.median(
        r.time_ms for r in rs.query(op=op) if r.run >= 0)
    cold = [r.time_ms for r in rs.query(op="init_forward")
            if r.plan_cache == "miss"]
    return {"node": pname, "client": client, "rigor": rigor,
            "pick": plan.candidate.key(), "plan_source": plan.source,
            "row_plan_sources": sorted({r.plan_source for r in rs.rows
                                        if r.library == client
                                        and r.op != "validate"}),
            "plan_ms": plan.plan_time_ms,
            "init_forward_cold_ms": cold[0] if cold else None,
            "execute_forward_ms": med("execute_forward"),
            "execute_inverse_ms": med("execute_inverse"),
            "launches": launched, "measured_ms": plan.measured_ms,
            "node_s": node_s, "_plan": plan}


def _check_launches(node: dict, problem) -> None:
    """The node launched its pick's kernels and no other (a sweep: the
    kernels of the candidates it timed, whose engines may differ, as
    chirp-Z's ``engine`` knob does)."""
    from repro_torch.core.candidates import Candidate
    want = _kernels_of(node["_plan"].candidate, problem)
    for key in node["measured_ms"]:
        want |= _kernels_of(Candidate.from_key(key), problem)
    wrong = {k: c for k, c in node["launches"].items()
             if (c > 0) != (k in want)}
    if wrong:
        raise AssertionError(
            f"{node['client']} {node['rigor']} {node['node']}: pick "
            f"{node['pick']} runs {sorted(want)}, launched "
            f"{node['launches']}")


def _emit_node(node: dict) -> None:
    emit({k: v for k, v in node.items() if k != "_plan"})


def run_planner(device) -> dict:
    """The planner's paths: ESTIMATE on P1-P14 (the dft_matmul kernel's
    main path: the launch counts are set to 0 just before it and read just
    after), MEASURE on ``MEASURE_NAMES`` with a fresh wisdom file, the
    pinned clients' PATIENT sweeps into the same file, every swept
    candidate's forward against torch.fft's, and WISDOM_ONLY on that
    file.  Returns the ESTIMATE path's dft_matmul launches and launch
    shapes, and the shapes the paths launched each kernel with."""
    from repro_torch.core.candidates import candidates
    from repro_torch.core.client import TorchContext
    from repro_torch.core.clients import torch_fft
    from repro_torch.core.suite import Session
    from repro_torch.core.wisdom import Wisdom

    names = [p[0] for p in PROBLEMS]
    table = {p: {"node": p} for p in names}

    session = Session(TorchContext(device))
    _reset_counts()
    for pname in names:
        node = _planned_node(session, pname, "estimate")
        _emit_node(node)
        if node["pick"] != ESTIMATE_PICKS[pname]:
            raise AssertionError(f"TorchPlanned ESTIMATE {pname} picked "
                                 f"{node['pick']}, the reference picks "
                                 f"{ESTIMATE_PICKS[pname]}")
        _check_launches(node, _problem(pname))
        table[pname].update(estimate_pick=node["pick"],
                            estimate_init_forward_cold_ms=node[
                                "init_forward_cold_ms"],
                            estimate_execute_forward_ms=node[
                                "execute_forward_ms"])
    dft_ops, _ = kernel_ops("dft_matmul")
    launches, shapes = dft_ops.LAUNCHES, dict(dft_ops.LAUNCH_SHAPES)
    sweep_shapes = [_launch_shapes()]
    emit({"main_path": "TorchPlanned estimate", "launches": _counts()})
    if launches <= 0:
        raise AssertionError("TorchPlanned ESTIMATE did not launch dft_matmul")

    if os.path.exists(WISDOM_PATH):
        os.remove(WISDOM_PATH)
    session = Session(TorchContext(device))
    names = list(MEASURE_NAMES)
    _reset_counts()
    for pname in names:
        node = _planned_node(session, pname, "measure", WISDOM_PATH)
        _emit_node(node)
        want = {c.key() for c in candidates(_problem(pname))}
        times = node["measured_ms"]
        if node["plan_source"] != "measure" or set(times) != want \
                or not all(math.isfinite(t) for t in times.values()):
            raise AssertionError(
                f"TorchPlanned MEASURE {pname}: source {node['plan_source']}"
                f", candidates {sorted(want)}, timed {times}")
        table[pname].update(measure_pick=node["pick"],
                            measure_init_forward_cold_ms=node[
                                "init_forward_cold_ms"],
                            measure_execute_forward_ms=node[
                                "execute_forward_ms"],
                            candidates=len(times))
    sweep_shapes.append(_launch_shapes())
    emit({"main_path": "TorchPlanned measure", "launches": _counts()})

    session = Session(TorchContext(device))
    _reset_counts()
    for client, pname in PATIENT_PATHS:
        node = _planned_node(session, pname, "patient", WISDOM_PATH, client)
        _emit_node(node)
        problem = _problem(pname)
        backend = getattr(torch_fft, client).backend_filter
        want = {c.key() for c in candidates(problem, patient=True)
                if c.backend == backend}
        times = node["measured_ms"]
        if node["plan_source"] != "patient" or len(want) < 2 \
                or set(times) != want \
                or not all(math.isfinite(t) for t in times.values()):
            raise AssertionError(
                f"{client} PATIENT {pname}: source {node['plan_source']}, "
                f"knobs {sorted(want)}, timed {times}")
        _check_launches(node, problem)
        rec = Wisdom(WISDOM_PATH, device_kind=session.device_kind).lookup(
            problem, scope=backend)
        if rec is None or rec.key() != node["pick"]:
            raise AssertionError(f"{client} PATIENT {pname}: wisdom holds "
                                 f"{rec and rec.key()}, picked {node['pick']}")
    sweep_shapes.append(_launch_shapes())
    emit({"main_path": "pinned clients patient", "launches": _counts()})

    for pname in names:
        check_candidates(device, pname, candidates(_problem(pname)))
    for client, pname in PATIENT_PATHS:
        backend = getattr(torch_fft, client).backend_filter
        check_candidates(device, pname, [
            c for c in candidates(_problem(pname), patient=True)
            if c.backend == backend])

    session = Session(TorchContext(device))
    for pname in names:
        node = _planned_node(session, pname, "wisdom_only", WISDOM_PATH)
        _emit_node(node)
        if node["plan_source"] != "wisdom" \
                or node["row_plan_sources"] != ["wisdom"] \
                or node["pick"] != table[pname]["measure_pick"]:
            raise AssertionError(
                f"TorchPlanned WISDOM_ONLY {pname}: source "
                f"{node['plan_source']} (rows {node['row_plan_sources']}), "
                f"pick {node['pick']}, MEASURE picked "
                f"{table[pname]['measure_pick']}")
        _check_launches(node, _problem(pname))
        table[pname].update(wisdom_init_forward_cold_ms=node[
                                "init_forward_cold_ms"],
                            wisdom_execute_forward_ms=node[
                                "execute_forward_ms"])
    for pname in table:
        emit({"planning": table[pname]})
    return {"launches": launches, "shapes": shapes,
            "sweep_shapes": sweep_shapes}


def _events_ms(fn, reps: int) -> float:
    """Median of ``reps`` single-call times from CUDA events (after one
    warm call)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


class Shape:
    """One (kernel, launch shape) of the main path: its input, the kernel
    call with the main path's knobs, the plain versions, the torch.fft
    call of the same function, and the work it does.  A fold's shape
    (key ``("rfft", n, rows, dtype)``, ``("irfft2", n1, n2, signals,
    dtype)``, ...) runs that one direction on real rows (their bins for an
    inverse)."""

    def __init__(self, kernel: str, key: tuple, device, gen):
        import torch
        self.kernel, self.key = kernel, key
        self.ops, self.ref = kernel_ops(kernel)
        self.fold = key[0] if isinstance(key[0], str) else None
        dims = key[1:] if self.fold else key
        dname = key[-1]
        dtype = getattr(torch, dname)
        if kernel == "fft2_pallas":
            n1, n2, rows, _ = dims
            self.shape = {"n1": n1, "n2": n2, "rows": rows, "dtype": dname}
            sig = (n1, n2)
        else:
            n, rows, _ = dims
            self.shape = {"n": n, "rows": rows, "dtype": dname}
            sig = (n,)
        self.n = math.prod(sig)
        self.rows = rows
        self.dname = dname
        if self.fold:
            self.shape["fold"] = self.fold
            real = torch.float64 if dname == "complex128" else torch.float32
            x = torch.randn((rows, *sig), dtype=real, device=device,
                            generator=gen)
            self.x = torch.fft.rfftn(x, dim=tuple(range(-len(sig), 0))) \
                if self.fold.startswith("i") else x
            self.sig = sig
        else:
            self.x = torch.randn((rows, *sig), dtype=dtype, device=device,
                                 generator=gen)

    def kernel_call(self, inverse: bool = False, plan=None):
        if self.fold:
            plan = plan or self.plan()[0]
            tw, roots = plan
            last = self.sig[-1]
            fn = getattr(self.ops, self.fold)
            if self.fold.startswith("i"):
                return fn(self.x, last, twiddles=tw, roots=roots)
            return fn(self.x, twiddles=tw, roots=roots)
        if self.kernel == "dft_matmul":
            return self.ops.dft(self.x, inverse, matrix=plan)
        fn = self.ops.fft2 if self.kernel == "fft2_pallas" else self.ops.fft
        return fn(self.x, inverse, twiddles=plan)

    def oracle(self, inverse: bool):
        if self.kernel == "dft_matmul":
            return _dft_plain(self.ref, self.x, inverse)
        if self.kernel == "stockham_pallas":
            return self.ref.stockham_ref(self.x, 8, inverse)
        if self.kernel == "fft2_pallas":
            return self.ref.fft2_ref(self.x, 8, inverse)
        return self.ref.fft4step_ref(self.x, inverse)

    def plan(self):
        """The forward plan, and the plain version of the kernel's own
        arithmetic on it (what ``plain_ms`` times); a fold's plan is the
        packed length's (or tile's) twiddles in its direction and the pack
        table."""
        device, dtype = self.x.device, self.x.dtype
        if self.fold:
            from repro_torch.fft.reference import half_roots
            import torch
            cdtype = torch.complex128 if self.dname == "complex128" \
                else torch.complex64
            inverse = self.fold.startswith("i")
            last = self.sig[-1]
            if self.kernel == "fft2_pallas":
                tw = self.ops.make_twiddles2(self.sig[0], last // 2, 8,
                                             inverse, cdtype, device)
            else:
                m = last // 2 if last % 2 == 0 else last
                tw = self.ops.make_twiddles(m, 8, inverse, cdtype, device)
            roots = half_roots(last, inverse, cdtype, device=device) \
                if last % 2 == 0 else None
            return (tw, roots), lambda: _fold_plain(
                self.ops, self.x, tw, roots, inverse, last,
                self.kernel == "fft2_pallas")
        if self.kernel == "dft_matmul":
            m = self.ops.make_matrix(self.n, False, dtype, device)
            return m, lambda: self.ops.plain(self.x, m, False)
        if self.kernel == "stockham_pallas":
            t = self.ops.make_twiddles(self.n, 8, False, dtype, device)
            return t, lambda: self.ops.plain(self.x, t, False)
        if self.kernel == "fft2_pallas":
            n1, n2 = self.shape["n1"], self.shape["n2"]
            t = self.ops.make_twiddles2(n1, n2, 8, False, dtype, device)
            return t, lambda: self.ops.plain(self.x, t, False)
        t = self.ops.make_tables(self.n, False, dtype, device)
        return t, lambda: self.ref.apply_fourstep(self.x, t.w1, t.w2, t.t)

    def default_tile(self) -> int:
        """The four-step kernel's default tile at this shape."""
        n1, n2 = self.ops.choose_factors(self.n)
        return self.ops.default_tile_b(n1, n2, self.rows,
                                       self.x.element_size())

    def tile_sweep(self, plan) -> dict:
        """Four-step kernel ms (CUDA events, median of ``TIMING_REPS``) at
        tiles of 1 to 32 signals that fit a block."""
        n1, n2 = self.ops.choose_factors(self.n)
        return {t: _events_ms(lambda: self.ops.fft(
                    self.x, False, tile_b=t, twiddles=plan), TIMING_REPS)
                for t in (1, 2, 4, 8, 16, 32)
                if t <= self.rows and self.ops.smem_bytes(
                    n1, n2, t, self.x.element_size())
                <= self.ops.SMEM_LIMIT_BYTES}

    def library(self):
        import torch
        if self.fold:
            dims = tuple(range(-len(self.sig), 0))
            if self.fold.startswith("i"):
                return torch.fft.irfftn(self.x, s=self.sig, dim=dims)
            return torch.fft.rfftn(self.x, dim=dims)
        if self.kernel == "fft2_pallas":
            return torch.fft.fft2(self.x)
        return torch.fft.fft(self.x)

    @property
    def tol(self) -> float:
        return PLAIN_TOL[self.dname]

    def pairs(self):
        """(what, kernel output, plain oracle) of the shape's checks: both
        directions with the main path's knobs (a fold: its direction,
        against ``fft/rfft.py``'s packing around the plain stages)."""
        if self.fold:
            plan, plain = self.plan()
            yield self.fold, self.kernel_call(plan=plan), plain()
            return
        for inverse in (False, True):
            yield f"inverse={inverse}", self.kernel_call(inverse), \
                self.oracle(inverse)

    def bytes_moved(self) -> int:
        """One read of the input and one write of the output: the signal
        each way, or for a fold the real signal one way and its bins (n/2
        + 1 on the last axis) the other."""
        itemsize = 16 if self.dname == "complex128" else 8
        if self.fold:
            bins = self.n // self.sig[-1] * (self.sig[-1] // 2 + 1)
            return self.rows * (self.n * itemsize // 2 + bins * itemsize)
        return 2 * self.rows * self.n * itemsize

    def bound(self) -> tuple[float, str]:
        """The least time for this function: its bytes (one read and one
        write, ``bytes_moved``) over the HBM rate, or the 5 n log2(n) flops
        per signal that a length-n DFT needs (half that for a real
        signal's) over the dtype's peak, whichever is larger.  The same for
        every kernel, whatever its algorithm."""
        bytes_ms = self.bytes_moved() / HBM_BYTES_PER_S * 1e3
        flops = 5 * self.n * math.log2(self.n) * self.rows
        if self.fold:
            flops /= 2
        ops_ms = flops / PEAK_FLOPS[self.dname] * 1e3
        return (bytes_ms, "bytes") if bytes_ms >= ops_ms \
            else (ops_ms, "operations")

    def algorithm_ops_ms(self) -> float | None:
        """The kernel's own flops over the peak of the units that run them,
        what its algorithm costs beyond the bound: for the four-step kernel
        the tensor-core products, 3 * 8 (n1 + n2) TF32 flops per point at
        the TF32 peak in complex64 (3xTF32) and 8 (n1 + n2) at the fp64
        peak in complex128; 8n per point for the dft kernel's direct
        product (fp32/fp64 on the CUDA cores); None for the FFTs in stages
        or registers (Stockham, fft2, the dft kernel on a 7-smooth n),
        whose flops are about the 5 n log2(n)."""
        peak = PEAK_FLOPS[self.dname]
        if self.kernel == "fft4step":
            n1, n2 = self.ops.choose_factors(self.n)
            per_point = 8 * (n1 + n2)
            if self.dname == "complex64":
                per_point, peak = 3 * per_point, PEAK_TF32
        elif self.kernel == "dft_matmul" and not self.ops.smooth7(self.n):
            per_point = 8 * self.n
        else:
            return None
        return per_point * self.n * self.rows / peak * 1e3


class ConvShape(Shape):
    """One fftconv launch shape (C, B, L, K, tile_b) of the main path: its
    signals and filters, the kernel on prepared operands, the plain
    version on the same operands, the unfused torch.fft path of the same
    convolution, and the work it does."""

    def __init__(self, kernel: str, key: tuple, device, gen):
        self.kernel, self.key = kernel, key
        self.ops, self.ref = kernel_ops(kernel)
        c, b, L, K, tile = key
        self.x, self.h = _conv_inputs(device, gen, c, b, L, K)
        self.tile = tile
        self.n = self.ops._next_square_pow2(L + K - 1)
        self.dname = "float32"
        self.shape = {"channels": c, "batch": b, "length": L, "taps": K,
                      "n": self.n, "tile_b": tile, "dtype": "float32"}

    def kernel_call(self, inverse: bool = False, plan=None):
        """The whole wrapper (``plan`` None), or the kernel alone on
        prepared operands."""
        if plan is None:
            return self.ops.fftconv(self.x, self.h, tile_b=self.tile)
        return self.ops.run_kernel(plan)

    @property
    def tol(self) -> float:
        return CONV_TOL

    def pairs(self):
        op = self.ops.prepare(self.x, self.h, tile_b=self.tile)
        y = self.ops.run_kernel(op)
        yield "plain", y, op.plain()
        yield "float64 oracle", y.double(), self.ref.fftconv_ref(
            self.x.double(), self.h.double(), self.n)

    def plan(self):
        op = self.ops.prepare(self.x, self.h, tile_b=self.tile)
        return op, op.plain

    def tile_sweep(self) -> dict:
        """Kernel ms (CUDA events, median of ``TIMING_REPS``) at every tile
        that fits a block, up to the largest: the check on
        ``DEFAULT_TILE_B``."""
        out = {}
        for t in range(1, self.ops.largest_tile_b(self.n) + 1):
            op = self.ops.prepare(self.x, self.h, tile_b=t)
            out[t] = _events_ms(lambda: self.ops.run_kernel(op), TIMING_REPS)
            del op
        return out

    def library(self):
        """The unfused torch.fft path (``fft/fftconv.py``, backend
        ``xla``) on the same convolution in its (1, L, C*B) layout."""
        from repro_torch.fft import fftconv
        if not hasattr(self, "_unfused"):
            c, b, L = self.x.shape
            xt = self.x.reshape(c * b, L).T.contiguous()[None]
            ht = self.h.repeat_interleave(b, dim=0).T.contiguous()
            self._unfused = (xt, ht)
        return fftconv.fftconv(*self._unfused, backend="xla")

    def bytes_moved(self) -> int:
        """What the convolution must move: the (C, B, L) signals read and
        the (C, B, L) results written once, and the (C, K) taps read
        once, all float32."""
        c, b, L = self.x.shape
        return 4 * (2 * c * b * L + c * self.h.shape[-1])

    def bound(self) -> tuple[float, str]:
        """The least time for the convolution: its bytes over the HBM
        rate, or its flops over the fp32 peak, whichever is larger.  The
        flops: a real length-n FFT (2.5 n log2(n)) of each signal, of each
        filter and of each product, and the product itself (6 flops on
        each of the n/2 + 1 bins of each signal)."""
        c, b = self.x.shape[:2]
        bytes_ms = self.bytes_moved() / HBM_BYTES_PER_S * 1e3
        fft = 2.5 * self.n * math.log2(max(self.n, 2))
        flops = fft * (2 * c * b + c) + 6 * (self.n // 2 + 1) * c * b
        ops_ms = flops / PEAK_FLOPS["float32"] * 1e3
        return (bytes_ms, "bytes") if bytes_ms >= ops_ms \
            else (ops_ms, "operations")

    def algorithm_ops_ms(self) -> float:
        """The kernel's own flops over the fp32 peak: per signal two
        complex FFTs of n/2 points (5 (n/2) log2(n/2) each) and the
        spectral pass's ~40 flops per bin pair."""
        c, b = self.x.shape[:2]
        half = self.n // 2
        flops = 10 * half * math.log2(max(half, 2)) + 20 * half
        return flops * c * b / PEAK_FLOPS["float32"] * 1e3


def _shapes(main_path: dict, device, seed: int):
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    for kernel, shapes in main_path["shapes"].items():
        for key in sorted(shapes, key=str):
            cls = ConvShape if kernel == "fftconv" else Shape
            yield cls(kernel, key, device, gen), shapes[key]


def check_main_path_shapes(device, main_path: dict) -> dict:
    """At every shape the main path (and the planner's sweeps) launched
    each kernel with, the kernel
    with the main path's own knobs (radix 8, default tile) against its
    plain oracle in both directions (fftconv: against its plain version
    and the float64 oracle); raises above the kernel's tolerance.  Returns
    the worst rel-L2 and absolute error per shape."""
    import torch
    errors = {}
    for s, _ in _shapes(main_path, device, 5):
        rel = err = 0.0
        for what, y, want in s.pairs():
            torch.cuda.synchronize(device)
            e = rel_l2(y, want)
            if not e <= s.tol:
                raise AssertionError(
                    f"{s.kernel} kernel disagrees at a main-path shape "
                    f"{s.shape} {what}: rel_l2 vs plain {e:.3e}")
            rel = max(rel, e)
            err = max(err, float((y - want).abs().max()))
            del y, want
        errors[(s.kernel, s.key)] = {"rel_l2_plain": rel, "max_abs_err": err}
        emit({"check": "main_path_shape", "kernel": s.kernel, **s.shape,
              **errors[(s.kernel, s.key)]})
        del s
        torch.cuda.empty_cache()
    return errors


def time_kernels(device, main_path: dict, errors: dict) -> list[dict]:
    """Kernel, plain and torch.fft times at every main-path shape."""
    import torch
    rows_out = []
    for s, launches in _shapes(main_path, device, 7):
        plan, plain = s.plan()
        bound_ms, bound_by = s.bound()
        row = {"kernel": s.kernel, **s.shape, "launches": launches,
               "ms": _events_ms(lambda: s.kernel_call(plan=plan), TIMING_REPS),
               "plain_ms": _events_ms(plain, PLAIN_REPS),
               "library_ms": _events_ms(s.library, TIMING_REPS),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "algorithm_ops_ms": s.algorithm_ops_ms(),
               "bytes_moved": s.bytes_moved(),
               **errors[(s.kernel, s.key)]}
        if s.kernel == "fftconv":
            # the whole wrapper (operands included), and the kernel at
            # every tile that fits a block: fewer signals per block, more
            # blocks per SM
            row["op_ms"] = _events_ms(s.kernel_call, TIMING_REPS)
            row["tile_sweep_ms"] = s.tile_sweep()
        elif s.kernel == "fft4step":
            # the kernel at tiles of 1 to 32 signals that fit a block: the
            # check on its default tile
            row["default_tile_b"] = s.default_tile()
            row["tile_sweep_ms"] = s.tile_sweep(plan)
        emit({"timing": row})
        rows_out.append(row)
        del s, plan, plain
        torch.cuda.empty_cache()
    return rows_out


def time_extra(device) -> list[dict]:
    """The ``EXTRA_TIMING`` shapes: each kernel with its default plan
    against its plain oracle in both directions (raises above its
    tolerance), then its time beside its plain version, the library call
    and its bound.  Not the main path's: ``launches`` is 0."""
    import torch
    import gc
    gen = torch.Generator(device=device).manual_seed(11)
    rows = []
    for kernel, key in EXTRA_TIMING:
        s = Shape(kernel, key, device, gen)
        rel = err = 0.0
        for what, y, want in s.pairs():
            torch.cuda.synchronize(device)
            e = rel_l2(y, want)
            if not e <= s.tol:
                raise AssertionError(f"{kernel} disagrees at {s.shape} {what}: "
                                     f"rel_l2 vs plain {e:.3e}")
            rel, err = max(rel, e), max(err, float((y - want).abs().max()))
            del y, want
        plan, plain = s.plan()
        bound_ms, bound_by = s.bound()
        row = {"kernel": kernel, **s.shape, "launches": 0,
               "ms": _events_ms(lambda: s.kernel_call(plan=plan), TIMING_REPS),
               "plain_ms": _events_ms(plain, PLAIN_REPS),
               "library_ms": _events_ms(s.library, TIMING_REPS),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "algorithm_ops_ms": s.algorithm_ops_ms(),
               "bytes_moved": s.bytes_moved(), "rel_l2_plain": rel,
               "max_abs_err": err}
        emit({"timing": row, "phase": "extra"})
        rows.append(row)
        del s, plan, plain
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    # the plain versions' products run in full fp32, as the kernels do
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    emit(card_info())
    emit({"build_s": build()})
    emit({"kernels": [k for k, _, _ in KERNELS]})
    t_checks = time.perf_counter()
    checks = check_kernels(device)
    checks.update(check_capacity(device))
    checks.update(check_folds(device))
    emit({"kernel_checks_s": time.perf_counter() - t_checks})
    t_main = time.perf_counter()
    main_path = run_main_path(device)
    emit({"main_paths_s": time.perf_counter() - t_main})
    check_failed_node(device)
    backends = run_backends_nodes(device)
    t_large = time.perf_counter()
    large = run_large_paths(device)
    emit({"large_paths_s": time.perf_counter() - t_large})
    for kernel, n in large["launches"].items():
        main_path["launches"][kernel] += n
        for key, c in large["shapes"][kernel].items():
            shapes = main_path["shapes"][kernel]
            shapes[key] = shapes.get(key, 0) + c
    t_planner = time.perf_counter()
    planner = run_planner(device)
    emit({"planner_s": time.perf_counter() - t_planner})
    t_tables = time.perf_counter()
    run_tables(device)
    emit({"tables_phase_s": time.perf_counter() - t_tables})
    t_cli = time.perf_counter()
    run_cli(device)
    run_paper_tables(device)
    emit({"cli_tables_phase_s": time.perf_counter() - t_cli})
    t_traj = time.perf_counter()
    run_trajectory(device)
    emit({"trajectory_phase_s": time.perf_counter() - t_traj})
    main_path["launches"]["dft_matmul"] = planner["launches"]
    main_path["shapes"]["dft_matmul"] = planner["shapes"]
    t_conv = time.perf_counter()
    checks[("fftconv", "float32")] = check_fftconv(device)
    conv = run_fftconv_path(device)
    emit({"fftconv_phases_s": time.perf_counter() - t_conv})
    main_path["launches"]["fftconv"] = conv["launches"]["fftconv"]
    main_path["shapes"]["fftconv"] = conv["shapes"]["fftconv"]
    checked = {k: dict(v) for k, v in main_path["shapes"].items()}
    others = {k: v for k, v in conv["shapes"].items() if k != "fftconv"}
    for sweep in planner["sweep_shapes"] + [others, backends["shapes"]]:
        for kernel, shapes in sweep.items():
            for key, n in shapes.items():
                checked.setdefault(kernel, {}).setdefault(key, 0)
                checked[kernel][key] += n
    t_shapes = time.perf_counter()
    errors = check_main_path_shapes(device, {"shapes": checked})
    emit({"shape_checks_s": time.perf_counter() - t_shapes})
    t_timing = time.perf_counter()
    timings = time_kernels(device, main_path, errors)
    time_extra(device)
    emit({"timing_phases_s": time.perf_counter() - t_timing})

    summary = []
    for kernel, source, replaces in KERNELS:
        mine = [t for t in timings if t["kernel"] == kernel]
        # the headline shape: the one that moved the most bytes on the
        # main path
        head = max(mine, key=lambda t: t["launches"] * t["bytes_moved"])
        shape = {k: head[k] for k in ("fold", "n", "n1", "n2", "rows",
                                      "channels", "batch", "length", "taps",
                                      "tile_b", "dtype") if k in head}
        summary.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": main_path["launches"][kernel],
            "max_abs_err": max(head["max_abs_err"],
                               *(c["max_abs_err"] for (k, _), c in
                                 checks.items() if k == kernel)),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": shape,
        })
    emit({"total_s": time.perf_counter() - t_start})
    emit({"kernels": summary})
    emit(card_info())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
