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
12. drives the serving slice (``repro_torch.serve``) on ``cuda:0``: S1,
   a Zipf mix at full width (``SERVE_S1``: 4096, 1024, 945, 128 and
   64x64, both out-of-place kinds, 160 requests of 512 rows, closed loop;
   one worker, two batches in flight, 4096-row coalesced batches) on a
   fresh ``FFTService`` for each of ``SERVE_S1_RUNS`` (the planner under
   ESTIMATE, ``xla``, ``stockham_pallas`` and ``fourstep_pallas`` over the
   mix, ``fft2_pallas`` over its 64x64 entries); S2, the reference's
   serve-table replay (``table_serve.REPLAY``: 96 requests open loop at
   300 Hz, ``max_batch`` 16, prewarmed) on the planner; the coalesced
   against serial burst at 4096; ``bench_grid --serve --chaos --smoke``
   (its ``main``; both scenarios must grade as recovered);
   ``TorchServeFFT`` through ``Session.run``; and the ``serve`` table
   through ``benchmarks.run``'s ``main``.  Each replay: every request
   completed, no error, timeout, demotion, worker error or quarantine;
   every result against ``torch.fft`` of its payload (rel-L2 <= 1e-3);
   one request per mix entry of a pinned kernel replay against the
   kernel's plain version on its first ``SERVE_PLAIN_ROWS`` rows (<= 1e-5);
   the launch counts set to 0 just before the traffic and read just after
   (a pinned replay launches its kernels and no other, ``xla`` none, the
   planner exactly its served picks' kernels); the same tape again under
   ``torch.profiler``, whose device kernels must be the same kernels'
   entry points (``KERNEL_SYMBOLS``), and cuFFT's only where the replay
   is ``xla`` or a pick runs it; one line each with p50/p95/p99,
   requests/s, GiB/s, the coalesce rate, batches, padded rows and the
   picks.  Figs. 4-5's ``measure_vs_wisdom_only`` lines (step 10) carry
   each rigor's median ``execute_forward``;
13. drives the distributed slice at one rank: a one-rank ``nccl`` group
   through a ``FileStore`` under ``build/dist/``, ``flat_mesh()`` over it,
   and ``Session.run`` of ``TorchDistFFT1D`` on D1 (2^26 complex64, split
   8192 x 8192) and on D1 with ``dist_natural``, and of ``TorchDistFFTND``
   on D2 (512 x 512 x 256 complex64, ``slab[1]``) and D3 (128^3 x 16
   complex128, ``slab[1]``), each validated with the launch and collective
   counts set to 0 just before it and read just after: the four-step
   kernel alone (D1, D2) or the dft kernel alone (D3), and the
   reference's all_to_alls per direction (2, 3 with natural order, 1 for
   a slab); each node's forward against ``torch.fft`` (in the transposed
   order where the layout is), its all_to_all bytes, the collective's
   CUDA-event time and ``torch.profiler``'s split into the kernels, the
   collective and the torch passes; then ``bench_grid --devices 1
   --smoke`` (its ``main``): every ``dist1d``, ``slab`` and
   ``pencil[1x1]`` row the support rules admit is ok;
14. serves the LM path (``repro_torch.launch.serve``) at full width in
   bf16 on ``cuda:0`` (``LM_CELLS``): L1, qwen3-1.7b, 16 requests of 512
   tokens through ``ServeEngine``'s 8 slots (two waves: the refill), 64
   new tokens each; L2, granite-moe-1b-a400m, 8 requests, 16 new; L3,
   hymba-1.5b (32 layers, 128 meta tokens, the 1024 window binding), 8
   requests of 1024, 32 new, max_len 2048; L4, xlstm-350m (24 layers),
   16 requests of 256 (two waves: the refill scatters the recurrent
   states), 32 new; L5, deepseek-v2-lite-16b cut to 9 of its 27 layers
   (1 dense + 8 MoE, MLA's absorbed cache), 8 requests of 512, 16 new; L6,
   llama-3.2-vision-90b cut to one unit (4 self layers and the gated cross
   layer, its gate set nonzero), through ``Model.prefill`` /
   ``decode_step`` with seeded image embeddings (the engine passes none),
   batch 4, prompt 256, 16 steps.  The weights float32 from a seeded
   generator on the card, cast once to bf16.  Every request done with
   its tokens, every logit finite; the float32 model decodes the token
   after a prefill of the first prompt within 1e-4 of the float32
   forward's column; the bf16 decode correlates above 0.999 with the bf16
   forward's column (an MoE whose bf16 routing parts from the forward's:
   no further from the float32 column than 2x the bf16 forward's; xlstm's
   recurrent decode against its chunked forward also with a largest
   difference under the bf16 forward's own from the float32 column: the
   reference's max abs < 0.5, "bf16-scale noise", at this model's scale);
   prefill and decode-step ms (CUDA events), tokens/s and their bounds
   (a recurrent state read and written once a step), a ``torch.profiler``
   split of one decode step and one prefill; the launch counts stay 0
   (no FFT kernel on the path);
15. trains the LM path (``repro_torch.train``) on ``cuda:0``
   (``TRAIN_CELLS``): T1, qwen3-1.7b at full width and depth, 10 steps of
   ``build_train_step`` at 8 x 512 tokens; T2, granite-moe-1b-a400m, 5
   steps (the capacity buffers under autograd); float32 parameters from a
   seeded generator, bf16 compute, remat on.  Checks: every loss and grad
   norm finite, the bf16 step-0 loss within 1% of the float32 one, the
   mean of the last three losses below step 0's, and (T1) the float32
   gradient at 1 x 512 with remat equal to the one without (rel-L2 <=
   1e-5 per leaf).  Step ms (CUDA events, median), tokens/s, the bound
   (6 N_active D at 989 TFLOP/s plus AdamW's 28 bytes a parameter at 3.35
   TB/s), a ``torch.profiler`` split of one more step (device ms and
   events, by kernel kind), the idle share, peak memory.  Then a
   ``Trainer`` checkpoint restart of reduced qwen3-1.7b (2 layers,
   float32) against a straight run (1e-5), and the ``lm_steps`` table's
   eight clients through ``Session.run``, every node validated; the
   launch counts stay 0 (no FFT kernel on the path);
15b. trains and serves the sharded LM path (``models/sharding.py``,
   DTensor) on a one-rank ``nccl`` group: M1, qwen3-1.7b at full width
   and depth on a (1, 1) ``data`` x ``model`` mesh (every parameter, m
   and v a DTensor), T1's weights and batches, 3 steps of
   ``build_train_step`` (step 0's loss within 1e-5 of the unsharded
   model's on the same weights and batch), step ms (CUDA events),
   tokens/s, a ``torch.profiler`` split, the idle share and peak memory
   beside T1's; a checkpoint of its parameters restores into the
   unsharded model with equal leaves; ``launch.train --mesh 1x1
   --reduced``; M2, the same model in float32 on that mesh, a prefill of
   8 x 512 tokens and 8 decode steps, its logits within 1e-4 (rel-L2) of
   the unsharded model's, and the bf16 decode step's ms beside the
   unsharded one's; the launch counts stay 0.  The dry run
   (``launch/dryrun.py``, one process a cell, the three started together
   after M1's timed steps, each on a fake group of 256 ranks on ``meta``,
   tracing on the host while the later phases run on the card; read after
   the timing phases): qwen3-1.7b train_4k, granite-moe-1b-a400m
   train_4k and starcoder2-7b prefill_32k at 16x16, each record's
   argument GiB, flops and collective MiB by kind and axis per device,
   rendered by ``roofline.analysis``;
16. holds the fused fftconv kernel against its plain version and the
   float64 oracle on fixed cases (every k, ragged tiles, every tile that
   fits), then drives its path: the port's kernel table
   (``repro_torch.benchmarks.table_kernels``) at the reference's sizes
   through ``Session.run``, every node validated and launching its
   client's kernel and no other, each kernel client's download against
   its plain counterpart; then the fused and unfused fftconv clients at a
   Hyena long convolution's width (F2, F3), with the launch counts set to
   0 before the table and read after F3;
17. holds each kernel against its plain version at every shape the main
   path (P1-P14), the backends nodes, the sweeps, the serving phase and
   the distributed phase launched it with
   (radix 8 and the default tile, both directions; fftconv against its
   plain version and the float64 oracle), then times it at the main
   path's shapes beside its plain version, the library call
   (``torch.fft``; for fftconv the unfused ``torch.fft`` path) and its
   bound, and sweeps the batch tile of the fftconv and four-step kernels
   there (the check on their defaults); then checks and times the
   multi-pass paths, the fused rank-2 kernel's complex transform of P6's
   tile and the dft kernel's direct product at 512 MiB shapes
   (``EXTRA_TIMING``);
18. prints the kernel summary (the distributed nodes' launches counted
   in) and, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits nonzero.  It needs a CUDA
device and the repository's ``src/`` beside it.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
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
#: The serving phase (``repro_torch.serve``): its files and fresh wisdom
#: under ``build/serve/``.  S1: the full-size Zipf mix (512 rows a request,
#: up to 16 MiB; a coalesced 4096-row batch of 4096-point complex64 is
#: 128 MiB each way), closed loop, with its service config; its replays
#: (backend, extents: None is the planner under ESTIMATE, and the whole
#: mix); S2 runs ``table_serve.REPLAY`` at the serve table's config.
SERVE_DIR = os.path.join(ROOT, "build", "serve")
SERVE_S1 = dict(extents=("4096", "1024", "945", "128", "64x64"),
                kinds=("Outplace_Complex", "Outplace_Real"),
                precisions=("float",), batch=512, requests=160,
                rate_hz=0.0, zipf_s=1.1, seed=2017)
SERVE_S1_CONFIG = dict(coalesce_window_ms=2.0, max_batch=4096, inflight=2)
SERVE_S1_RUNS = ((None, None), ("xla", None), ("stockham_pallas", None),
                 ("fourstep_pallas", None), ("fft2_pallas", ("64x64",)))
SERVE_S2_CONFIG = dict(coalesce_window_ms=2.0, max_batch=16)
#: Requests of the coalesced against serial burst (the serve table's).
SERVE_BURST = 128
#: The hand-written kernels' entry points as the profiler names them, and
#: the kernels each belongs to (``block_fft`` is the one-block body of the
#: Stockham and fused rank-2 kernels, the column pass their passes' form).
KERNEL_SYMBOLS = {
    "block_fft": {"stockham_pallas", "fft2_pallas"},
    "stockham_columns_kernel": {"stockham_pallas", "fft2_pallas"},
    "fft4step_kernel": {"fft4step"},
    "fft4step_columns_kernel": {"fft4step"},
    "fft4step_rows_kernel": {"fft4step"},
    "dft_fft_kernel": {"dft_matmul"},
    "dft_kernel": {"dft_matmul"},
    "fftconv_kernel": {"fftconv"},
}
#: Rows of one request per mix entry held against the pinned kernel's
#: plain version (the wrappers' CPU path; rows are independent).
SERVE_PLAIN_ROWS = 32
#: Requests per mix entry of the burst with a payload of its own that
#: follows each S1 replay: more than one ``max_batch`` of rows per plan,
#: submitted round robin over the entries, so that batches of one plan
#: follow each other through the worker's reused staging slots.
SERVE_DISTINCT = 12
#: Warmup runs of the planner phase's nodes, each then timed once (its
#: depth, cut to make room for the serving phase): the same for every
#: rigor, so that the four rigors' ``execute_forward`` times compare.
PLANNER_WARMUPS = 1
#: The paper tables the CLI phase runs: Figs. 2, 3, 4-5 and 8.
PAPER_TABLES = ("overhead", "tts", "plan_rigor", "dtypes")
#: Each client's main path: (client, its problems, the kernel it runs).
PATHS = (
    ("TorchFFT", ALL, None),
    ("TorchStockhamPallas", ALL, "stockham_pallas"),
    ("TorchFourStepPallas", ALL, "fft4step"),
    ("TorchFft2Pallas", ("P6", "P7"), "fft2_pallas"),
)
#: The distributed phase's nodes at full width on one rank: (name, client,
#: extents, kind, precision, batch, dist_natural, the one kernel its local
#: engines launch, all_to_alls per direction: the reference's
#: DIST_A2A_COUNT plus DIST_NATURAL_EXTRA).  D1 splits 8192 x 8192 (the
#: four-step kernel on both sides), D2 runs slab[1] with the four-step
#: kernel at 512, 512 and 256, D3 slab[1] with the dft kernel at 128 in
#: complex128; each is 512 MiB each way.
DIST_NODES = (
    ("D1", "TorchDistFFT1D", (1 << 26,), "Outplace_Complex", "float", 1,
     False, "fft4step", 2),
    ("D1 natural", "TorchDistFFT1D", (1 << 26,), "Outplace_Complex",
     "float", 1, True, "fft4step", 3),
    ("D2", "TorchDistFFTND", (512, 512, 256), "Outplace_Complex", "float", 1,
     False, "fft4step", 1),
    ("D3", "TorchDistFFTND", (128, 128, 128), "Inplace_Complex", "double",
     16, False, "dft_matmul", 1),
)
DIST_DIR = os.path.join(ROOT, "build", "dist")
#: The distributed nodes' Session.run: the warm-up builds, the repetitions
#: reuse the cached plans.
DIST_WARMUPS, DIST_REPS = 1, 1
#: Forwards under ``torch.profiler`` for a node's split (averaged).
DIST_PROFILED = 3
#: The ported kernels: (name, CUDA source, the TPU kernel it replaces).
#: The LM serving phase: (label, architecture, layers (None: all), slots,
#: max_len, requests, prompt tokens, new tokens), each at the config's
#: full width in its compute dtype.  L1 serves two waves through 8 slots
#: (the refill path); L2 puts the MoE layer at its published width on the
#: card; L3's 1024-token prompts and 128 meta tokens pass hymba's 1024
#: window; L4 refills slots with recurrent states; L5 and L6 are cut in
#: depth so that the float32 weights and their bf16 cast fit in 80 GB
#: with the checks (deepseek's 27 layers: 62 + 31 GB; one vision unit:
#: 26 + 13 GB).  L6 (``vlm``) runs through ``Model`` with image
#: embeddings, since the engine passes none; its slots are the batch.
LM_CELLS = (("L1", "qwen3-1.7b", None, 8, 1024, 16, 512, 64),
            ("L2", "granite-moe-1b-a400m", None, 8, 1024, 8, 512, 16),
            ("L3", "hymba-1.5b", None, 8, 2048, 8, 1024, 32),
            ("L4", "xlstm-350m", None, 8, 1024, 16, 256, 32),
            ("L5", "deepseek-v2-lite-16b", 9, 8, 1024, 8, 512, 16),
            ("L6", "llama-3.2-vision-90b", 5, 4, 272, 4, 256, 16))
#: the vlm's cross gate on the card (its init, 0, makes the layer add
#: nothing)
LM_CROSS_GATE = 0.7
#: cache leaves a dense decode reads whole; every other leaf is a
#: recurrent state, read and written once a step
LM_ATTENTION_LEAVES = ("k", "v", "c_kv", "k_rope")
#: float32 decode after a prefill against the float32 forward's column
LM_F32_TOL = 1e-4
#: bf16 decode logits against the bf16 forward's column (the reference's
#: ``tests/test_arch_smoke.py`` bar)
LM_BF16_CORR = 0.999
#: an MoE decode whose bf16 routing differs from the forward's: its
#: distance from the float32 column over the bf16 forward's, at most
LM_MOE_BF16_RATIO = 2.0
#: decode steps profiled per cell (a prefill is profiled once: xlstm's
#: sLSTM loop gives 73k device events a prefill, whose post-processing
#: took two minutes for three)
LM_PROFILED = 3
#: a device event's kind by its kernel name (the first pattern that
#: matches), for the profiled splits' ``by_kind``: matrix products
#: (cuBLAS / CUTLASS), ``_foreach`` (AdamW), scatter and gather and
#: indexing, reductions and softmax, other elementwise kernels, copies
DEVICE_EVENT_KINDS = (
    ("product", r"gemm|cutlass|sm90_|xmma|cublas|nvjet"),
    ("foreach", r"multi_tensor_apply"),
    ("scatter_gather", r"scatter|gather|index"),
    ("reduce_softmax", r"reduce|softmax|norm_kernel|cumsum|scan"),
    ("elementwise", r"elementwise"),
    ("copy", r"[Mm]emcpy|[Mm]emset|copy"),
)
#: H100 SXM dense bf16 tensor-core peak, the prefill bound's rate
BF16_FLOPS = 989e12
#: the training phase's cells: (label, arch, batch, sequence length,
#: steps).  T1 trains qwen3-1.7b at full width and depth (28 layers, 1.72 G
#: parameters; parameters, gradients, m and v 27.5 GB); T2 puts the MoE's
#: capacity buffers and the sum over experts under autograd at their
#: published width (granite-moe-1b-a400m, 24 layers, 32 experts top-8,
#: 21 GB of state).  float32 parameters from a seeded generator, bf16
#: compute, remat on, ``SyntheticTokens`` (seed 0) at 4096 tokens a step.
TRAIN_CELLS = (("T1", "qwen3-1.7b", 8, 512, 10),
               ("T2", "granite-moe-1b-a400m", 8, 512, 5))
#: AdamW's settings in both cells (the cell's steps are ``total_steps``)
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
#: the bf16 step-0 loss against the float32 loss on the same parameters
#: and batch, relative
TRAIN_BF16_TOL = 0.01
#: T1's float32 gradient at batch 1 x 512 with remat against without, per
#: leaf rel-L2 (the same ops recomputed; the embedding's backward
#: accumulates with atomics, in any order)
TRAIN_REMAT_TOL = 1e-5
#: the restart check: reduced qwen3-1.7b at 2 layers in float32, 2 steps,
#: a checkpoint, 2 more, against 4 straight; the final loss and every
#: parameter within this rel-L2
TRAIN_RESTART_TOL = 1e-5
#: AdamW's bytes a parameter a step: p, g, m, v read, p, m, v written
ADAMW_BYTES = 28
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
    fwd: dict = {}
    for spec, rs in session.runs:
        for r in rs.query(op="execute_forward", library="TorchPlanned"):
            fwd.setdefault((spec.rigor, r.extents), []).append(r.time_ms)
    for problem in sorted({p for r, p in picks if r == "measure"}):
        measure = sorted(set(picks[("measure", problem)]))
        wisdom = sorted(set(picks.get(("wisdom_only", problem), [])))
        ext = problem.split("/")[0]
        m_ms = statistics.median(fwd[("measure", ext)])
        w_ms = statistics.median(fwd[("wisdom_only", ext)])
        emit({"measure_vs_wisdom_only": problem,
              "same_pick": measure == wisdom, "measure": measure,
              "wisdom_only": wisdom, "measure_fwd_ms": m_ms,
              "wisdom_only_fwd_ms": w_ms, "ratio": m_ms / w_ms})
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


def _served_kernels(plans: dict) -> set:
    """The kernels of the plans a service served with (``served_plans``:
    problem signature to candidate key)."""
    from repro_torch.core.candidates import Candidate
    from repro_torch.core.client import Problem
    from repro_torch.core.extents import parse_extents
    out = set()
    for sig, key in plans.items():
        ext, precision, kind, _ = sig.split("/")
        out |= _kernels_of(Candidate.from_key(key),
                           Problem(parse_extents(ext), kind, precision))
    return out


def _profiled_kernels(fn) -> tuple[set, set]:
    """Run ``fn`` under ``torch.profiler`` and sort the device kernels it
    launched: the hand-written entry points (``KERNEL_SYMBOLS``) seen, and
    every other kernel that is not one of torch's own (copies, fills,
    reductions): cuFFT's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA}
    if not names:
        raise AssertionError("torch.profiler saw no device kernel")
    ours, library = set(), set()
    for name in names:
        hit = {s for s in KERNEL_SYMBOLS if re.search(rf"\b{s}\b", name)}
        if hit:
            ours |= hit
        elif "at::native" not in name and not name.startswith(("Memcpy",
                                                                "Memset")):
            library.add(name[:120])
    return ours, library


def _check_profiled(label: str, want: set, picks: dict, backend,
                    ours: set, library: set) -> None:
    """The profiled pass launched each kernel of ``want`` and only those,
    and cuFFT only where the replay is ``xla`` or a pick runs it."""
    seen = set().union(*(KERNEL_SYMBOLS[s] for s in ours)) if ours else set()
    stray = [s for s in ours if not KERNEL_SYMBOLS[s] & want]
    missing = [k for k in want if not any(k in KERNEL_SYMBOLS[s]
                                          for s in ours)]
    cufft = backend == "xla" or (backend is None and any(
        "xla" in key for key in picks.values()))
    if stray or missing or bool(library) != cufft:
        raise AssertionError(
            f"serve replay {label} under torch.profiler: hand-written "
            f"{sorted(ours)} (kernels {sorted(seen)}, want {sorted(want)}), "
            f"other kernels {sorted(library)[:8]}, picks {picks}")


def _serve_distinct(svc, spec, device) -> tuple[int, float]:
    """``SERVE_DISTINCT`` requests per mix entry of ``spec``, each with its
    own seeded payload (``_payloads`` gives every request of an entry the
    same one), submitted one at a time round robin over the entries; each
    delivered result against torch.fft of its own payload, so that rows
    delivered to another request, or a slab refilled before its copy out,
    show.  Returns the requests and the worst rel-L2."""
    import torch
    from repro_torch.core.client import Problem

    gen = torch.Generator(device=device).manual_seed(spec.seed)
    sent = []
    for _ in range(SERVE_DISTINCT):
        for ext, kind, prec in spec.mix():
            problem = Problem(ext, kind, prec, batch=spec.batch)
            shape = (spec.batch, *ext)
            real = (torch.float64 if prec == "double" else torch.float32)
            x = torch.randn(shape, dtype=real, device=device, generator=gen)
            if problem.complex_input:
                x = torch.complex(x, torch.randn(shape, dtype=real,
                                                 device=device,
                                                 generator=gen))
            req = svc.submit(x.cpu().numpy(), kind=kind, precision=prec,
                             rank=len(ext))
            sent.append((req, x, ext, prec))
    worst = 0.0
    for req, x, ext, prec in sent:
        dims = tuple(range(-len(ext), 0))
        ref = (torch.fft.fftn(x, dim=dims) if x.is_complex()
               else torch.fft.rfftn(x, dim=dims))
        got = torch.from_numpy(req.result(timeout=60)).to(device)
        e = rel_l2(got, ref)
        tol = LIBRARY_TOL["complex128" if prec == "double" else "complex64"]
        if not (got.shape == ref.shape and e <= tol):
            raise AssertionError(f"serve burst of distinct payloads: request "
                                 f"{req.rid} {req.plan_key}: rel_l2 "
                                 f"{e:.3e} against torch.fft of its payload")
        worst = max(worst, e)
    return len(sent), worst


def _serve_replay(device, label: str, spec, config: dict, backend,
                  wisdom_path: str, distinct: bool = False) -> dict:
    """One replay of ``spec`` on a fresh service pinned to ``backend``
    (None: the planner) with its launch counts set to 0 just before the
    traffic and read just after, then the same tape again under
    ``torch.profiler`` on the warm service, and with ``distinct`` the
    burst of distinct payloads (``_serve_distinct``); every check of the
    serving phase, then the run's line."""
    import numpy as np
    import torch
    from repro_torch.core.candidates import Candidate
    from repro_torch.core.client import Problem, TorchContext
    from repro_torch.core.clients.torch_fft import _forward_fn
    from repro_torch.core.suite import Session
    from repro_torch.core.wisdom import Wisdom
    from repro_torch.serve import FFTService, ServeConfig, replay
    from repro_torch.serve.replay import _payloads

    if os.path.exists(wisdom_path):
        os.remove(wisdom_path)
    wisdom = Wisdom(wisdom_path, device_kind=torch.cuda.get_device_name(0))
    cfg = ServeConfig(backend=backend, **config)
    t0 = time.perf_counter()
    with FFTService(Session(TorchContext(device)), cfg,
                    wisdom=wisdom) as svc:
        for ext, kind, prec in spec.mix():
            svc.prewarm(ext, kind, prec)
        torch.cuda.synchronize(device)
        prewarm_s = time.perf_counter() - t0
        _reset_counts()
        rep = replay(svc, spec, wait_timeout_s=300)
        launches = _counts()
        shapes = _launch_shapes()
        ours, library = _profiled_kernels(
            lambda: replay(svc, spec, wait_timeout_s=300))
        n_distinct, worst_distinct = (_serve_distinct(svc, spec, device)
                                      if distinct else (0, None))
        _reset_counts()
        again = svc.report()
    s = rep.service
    picks = svc.served_plans()
    quarantined = {k: v for k, v in again["quarantine"].items()
                   if v["state"] != "closed" or v["failures"]}
    bad = {k: again[k] for k in ("errors", "timeouts", "demotions")
           if again[k]}
    if s["completed"] != spec.requests or bad or again["worker_errors"] \
            or quarantined or len(rep.requests) != spec.requests \
            or again["completed"] != 2 * spec.requests + n_distinct:
        raise AssertionError(
            f"serve replay {label}: completed {s['completed']}/"
            f"{spec.requests} (with the profiled pass and {n_distinct} "
            f"distinct payloads {again['completed']}), "
            f"{bad}, worker errors {again['worker_errors']}, quarantine "
            f"{quarantined}")
    if backend is None:
        want = _served_kernels(picks)
    else:
        want = set().union(*(_kernels_of(Candidate(backend),
                                         Problem(ext, kind, prec))
                             for ext, kind, prec in spec.mix()))
    got = {k for k, c in launches.items() if c}
    if got != want:
        raise AssertionError(f"serve replay {label}: launched {launches}, "
                             f"its kernels {sorted(want)} (picks {picks})")
    _check_profiled(label, want, picks, backend, ours, library)
    # every delivered result against torch.fft of its payload on the card;
    # one request per mix entry of a pinned kernel replay against the
    # kernel's plain version on the same rows
    payloads = _payloads(spec)
    worst_lib = worst_plain = 0.0
    plain_checked = set()
    for key, x in payloads.items():
        ext, kind, prec = key
        xd = torch.from_numpy(x).to(device)
        dims = tuple(range(-len(ext), 0))
        ref = (torch.fft.fftn(xd, dim=dims) if xd.is_complex()
               else torch.fft.rfftn(xd, dim=dims))
        tol = LIBRARY_TOL["complex128" if prec == "double" else "complex64"]
        for req in rep.requests:
            if req.plan_key != key:
                continue
            got_y = torch.from_numpy(req.result(timeout=60)).to(device)
            e = rel_l2(got_y, ref)
            if not (got_y.shape == ref.shape and e <= tol):
                raise AssertionError(f"serve replay {label} request "
                                     f"{req.rid} {key}: rel_l2 {e:.3e} "
                                     "against torch.fft")
            worst_lib = max(worst_lib, e)
            if backend in (None, "xla") or key in plain_checked:
                continue
            rows = slice(0, SERVE_PLAIN_ROWS)
            problem = Problem(ext, kind, prec, batch=SERVE_PLAIN_ROWS)
            plain = _forward_fn(problem, Candidate(backend), "cpu")(
                torch.from_numpy(np.ascontiguousarray(x[rows])))
            e = rel_l2(got_y[rows].cpu(), plain)
            if not e <= PLAIN_TOL["complex64"]:
                raise AssertionError(f"serve replay {label} request "
                                     f"{req.rid} {key}: rel_l2 {e:.3e} "
                                     "against the plain version")
            worst_plain = max(worst_plain, e)
            plain_checked.add(key)
        del xd, ref
    served = {req.plan_key for req in rep.requests}
    if backend not in (None, "xla") and plain_checked != served:
        raise AssertionError(f"serve replay {label}: plain check ran on "
                             f"{len(plain_checked)}/{len(served)} entries")
    lat = s["latency_ms"]
    row = {"serve": label, "backend": backend or "planned",
           "extents": list(spec.to_dict()["extents"]),
           "rate_hz": spec.rate_hz, "requests": spec.requests,
           "rows": spec.batch, "max_batch": cfg.max_batch,
           "completed": s["completed"], "p50_ms": lat["p50"],
           "p95_ms": lat["p95"], "p99_ms": lat["p99"],
           "queue_p50_ms": s["queue_ms"]["p50"], "rps": s["rps"],
           "gib_per_s": s["gib_per_s"], "coalesce_rate": s["coalesce_rate"],
           "batches": s["batches"], "padded_rows": s["padded_rows"],
           "picks": picks, "launches": launches,
           "profiled_kernels": sorted(ours),
           "profiled_library": len(library),
           "rel_l2_torch_fft": worst_lib,
           "rel_l2_plain": worst_plain if plain_checked else None,
           "plain_rows": SERVE_PLAIN_ROWS if plain_checked else None,
           "distinct_requests": n_distinct,
           "rel_l2_distinct": worst_distinct,
           "prewarm_s": prewarm_s, "wall_s": rep.wall_s,
           "replay_s": time.perf_counter() - t0}
    emit(row)
    row["shapes"] = shapes
    del rep, payloads
    torch.cuda.empty_cache()
    return row


def run_serve(device) -> dict:
    """The serving slice's main path on the card (``repro_torch.serve``):
    S1, the full-size Zipf mix closed loop on each of ``SERVE_S1_RUNS``;
    S2, the reference's serve-table replay (``table_serve.REPLAY``: open
    loop at 300 Hz, ``max_batch`` 16) on the planner; the coalesced
    against serial burst at 4096; the chaos scenarios through
    ``bench_grid --serve --chaos --smoke``; ``TorchServeFFT`` through
    ``Session.run`` at P3's extent; and the ``serve`` table through
    ``benchmarks.run`` (both entry points called in process).  Returns
    the replays' kernel launches and launch shapes."""
    import contextlib
    import io

    import torch
    from repro_torch.benchmarks import bench_grid, table_serve
    from repro_torch.core.client import Problem, TorchContext
    from repro_torch.core.costmodel import estimate_choice
    from repro_torch.core.suite import Session, SuiteSpec
    from repro_torch.serve import TrafficSpec

    os.makedirs(SERVE_DIR, exist_ok=True)
    wisdom = os.path.join(SERVE_DIR, "wisdom.json")
    launches = {k: 0 for k, _, _ in KERNELS}
    shapes: dict = {}

    def add(row):
        for k, c in row["launches"].items():
            launches[k] += c
        for k, sh in row["shapes"].items():
            for key, c in sh.items():
                shapes.setdefault(k, {}).setdefault(key, 0)
                shapes[k][key] += c

    for backend, extents in SERVE_S1_RUNS:
        spec = TrafficSpec(**{**SERVE_S1, "extents": extents
                              or SERVE_S1["extents"]})
        add(_serve_replay(device, f"S1/{backend or 'planned'}", spec,
                          SERVE_S1_CONFIG, backend, wisdom, distinct=True))
    add(_serve_replay(device, "S2/planned", table_serve.REPLAY,
                      SERVE_S2_CONFIG, None, wisdom))

    _reset_counts()
    rec = bench_grid.bench_serve_burst(SERVE_BURST, 4096, device)
    rec["launches"] = {k: c for k, c in _counts().items() if c}
    emit(rec)
    if not rec["ok"] or rec["launches"]:
        raise AssertionError(f"serve burst: {rec}")

    out = os.path.join(SERVE_DIR, "chaos.json")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_grid.main(["--serve", "--chaos", "--smoke", "--device",
                              str(device), "--out", out])
    with open(out) as f:
        chaos = json.load(f)["results"]
    emit({"serve_chaos_rc": rc, "stdout": buf.getvalue().splitlines(),
          "chaos_s": time.perf_counter() - t0})
    if rc != 0 or len(chaos) != 2 or not all(r["ok"] for r in chaos):
        raise AssertionError(f"bench_grid --serve --chaos: rc {rc}: "
                             f"{buf.getvalue()[-2000:]}")

    _reset_counts()
    suite = SuiteSpec(clients=("TorchServeFFT",), extents=((4096,),),
                      kinds=("Outplace_Complex",), precisions=("float",),
                      batch=512, warmups=1, repetitions=3, output=None)
    rs = Session(TorchContext(device, {"serve_burst": 8,
                                       "serve_max_batch": 4096})).run(suite)
    val = rs.query(op="validate")
    suite_launches = {k: c for k, c in _counts().items() if c}
    fwd = [r.time_ms for r in rs.query(op="execute_forward")]
    emit({"serve_suite": "TorchServeFFT/4096/b512", "launches":
          suite_launches, "execute_forward_ms": fwd,
          "p50_ms": statistics.median(fwd)})
    want = set().union(*(
        _kernels_of(estimate_choice(Problem((4096,), "Outplace_Complex",
                                            "float", batch=b)),
                    Problem((4096,), "Outplace_Complex")) for b in (512, 4096)))
    if rs.failures() or len(val) != 1 or not val[0].success \
            or set(suite_launches) != want:
        raise AssertionError(f"TorchServeFFT through Session.run: "
                             f"{[(r.op, r.error) for r in rs.rows]}, "
                             f"launches {suite_launches}")

    from repro_torch.benchmarks import run as bench_run

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_run.main(["serve"])
    lines = buf.getvalue().splitlines()
    emit({"serve_table_rc": rc, "csv": lines,
          "table_s": time.perf_counter() - t0})
    names = [line.split(",")[0] for line in lines[1:]]
    if rc != 0 or not {"serve_replay/p50", "serve_burst/serial",
                       "serve_burst/coalesced"} <= set(names) \
            or not any(n.startswith("serve_suite/") for n in names):
        raise AssertionError(f"run serve: rc {rc}, rows {names}")
    emit({"serve_launches": launches})
    torch.cuda.empty_cache()
    return {"launches": launches, "shapes": shapes}


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
    spec = SuiteSpec(rigor=rigor, wisdom=wisdom,
                     warmups=PLANNER_WARMUPS, repetitions=1,
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


def _dist_spectrum(cls, problem, natural: bool, kernel: str, device,
                   gen) -> dict:
    """One node's forward on a fresh client, driven op by op: the
    spectrum against torch.fft of the same input (put in the transposed
    order where the layout is transposed), the all_to_alls and bytes one
    forward sends, and its device time split two ways into the local
    engines (``kernel``'s wrapper), the collective and the torch passes
    (transposes, the twiddle, copies): by CUDA events around the forward,
    each all_to_all and each engine call, and by ``torch.profiler``'s
    device events (NCCL's copy shows as ``Memcpy DtoD``), with their
    counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.client import TorchContext
    from repro_torch.fft import distributed as dfft

    ctx = TorchContext(device, {"dist_natural": natural})
    ctx.create()
    client = cls(problem, ctx)
    client.allocate()
    client.init_forward()
    shape = (problem.batch, *problem.extents)
    dtype = (torch.complex128 if problem.precision == "double"
             else torch.complex64)
    x = torch.randn(shape, dtype=dtype, device=device, generator=gen)
    client.upload(x.cpu().numpy())
    client.execute_forward()
    calls, sent = dfft.A2A_CALLS, dfft.A2A_BYTES
    client.execute_forward()
    out = {"a2a_per_forward": dfft.A2A_CALLS - calls,
           "a2a_bytes_per_forward": dfft.A2A_BYTES - sent}
    # the split by CUDA events: around the whole forward, each
    # all_to_all and each call of the local engines' wrapper
    ops, _ = kernel_ops(kernel)
    entry = "dft" if kernel == "dft_matmul" else "fft"
    real_a2a, real_eng = dfft.all_to_all, getattr(ops, entry)
    marks: dict = {"a2a": [], "engine": []}

    def timed(fn, what):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            y = fn(*args, **kwargs)
            stop.record()
            marks[what].append((start, stop))
            return y
        return call

    dfft.all_to_all = timed(real_a2a, "a2a")
    setattr(ops, entry, timed(real_eng, "engine"))
    try:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        client.execute_forward()
        stop.record()
        stop.synchronize()
    finally:
        dfft.all_to_all = real_a2a
        setattr(ops, entry, real_eng)
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in marks.items()}
    total = start.elapsed_time(stop)
    out["event_split"] = {"forward_ms": total, "engines_ms": ms["engine"],
                          "collective_ms": ms["a2a"],
                          "torch_ms": total - ms["engine"] - ms["a2a"]}
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(DIST_PROFILED):
            client.execute_forward()
        torch.cuda.synchronize(device)
    split = {"kernels_ms": 0.0, "collective_ms": 0.0, "torch_ms": 0.0}
    counts = {"kernels": 0, "collective": 0, "torch": 0}
    events: dict = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        # these repeat the time of the device work under them
        if e.key == "Activity Buffer Request" or e.key.startswith("nccl:"):
            continue
        ms_e = e.self_device_time_total / 1e3
        name = e.key[:80]
        events[name] = events.get(name, 0.0) + ms_e
        if any(re.search(rf"\b{k}\b", e.key) for k in KERNEL_SYMBOLS):
            what = "kernels"
        elif "nccl" in e.key.lower() or e.key.startswith(("Memcpy DtoD",
                                                           "Memcpy PtoP")):
            what = "collective"
        else:
            what = "torch"
        split[f"{what}_ms"] += ms_e / DIST_PROFILED
        counts[what] += e.count / DIST_PROFILED
    out["device_events"] = {k: v / DIST_PROFILED for k, v in sorted(
        events.items(), key=lambda kv: -kv[1])[:8]}
    out["profile_counts"] = counts   # device events a forward
    if not split["kernels_ms"] or not ms["a2a"]:
        raise AssertionError(f"{problem.signature()}: the forward shows "
                             f"no kernel or no collective: {split}, {out}")
    out["profile_split"] = split
    y = client._spec.reshape(shape)
    dims = tuple(range(1, len(shape)))
    want = torch.fft.fftn(x, dim=dims)
    if problem.rank == 1 and not natural:
        n1, n2 = dfft._choose_1d_factors(problem.extents[0], 1)
        want = want.reshape(n2, n1).T.reshape(shape)
    out["forward_rel_l2"] = rel_l2(y, want)
    tol = LIBRARY_TOL["complex128" if problem.precision == "double"
                      else "complex64"]
    if not out["forward_rel_l2"] <= tol:
        raise AssertionError(f"{problem.signature()}: the forward disagrees "
                             f"with torch.fft: rel_l2 "
                             f"{out['forward_rel_l2']:.3e} > {tol}")
    client.destroy()
    return out


def run_distributed(device) -> dict:
    """The distributed slice at one rank: a one-rank ``nccl`` group
    through a ``FileStore`` under ``build/``, ``flat_mesh()`` over it,
    then each of ``DIST_NODES`` through ``Session.run`` at ESTIMATE,
    validated, with the launch and collective counts set to 0 just before
    it and read just after (only its local engines' kernel launched; the
    reference's all_to_alls per direction); each node's forward against
    torch.fft, its all_to_all traffic and, for D1, the profiler's split;
    then ``bench_grid --devices 1 --smoke`` (its ``main``): every
    ``dist1d``, ``slab`` and ``pencil[1x1]`` row the support rules admit
    is ok.  Returns the launches and launch shapes of the nodes."""
    import contextlib
    import gc
    import io

    import torch
    import torch.distributed as dist

    from repro_torch.benchmarks import bench_grid
    from repro_torch.core.client import Problem, TorchContext
    from repro_torch.core.clients import dist_fft
    from repro_torch.core.suite import Session, SuiteSpec
    from repro_torch.core.tree import BenchNode
    from repro_torch.fft import distributed as dfft
    from repro_torch.launch.mesh import flat_mesh

    os.makedirs(DIST_DIR, exist_ok=True)
    store = os.path.join(DIST_DIR, "store")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1, device_id=device)
    mesh = flat_mesh()
    if dist.get_backend() != "nccl" or mesh.size != 1:
        raise AssertionError(f"one-rank group: backend "
                             f"{dist.get_backend()}, {mesh.size} ranks")
    launches = {k: 0 for k, _, _ in KERNELS}
    shapes: dict = {}
    gen = torch.Generator(device=device).manual_seed(11)
    spec = SuiteSpec(warmups=DIST_WARMUPS, repetitions=DIST_REPS,
                     plan_cache=True, output=None)
    runs = DIST_WARMUPS + DIST_REPS
    for (name, client, ext, kind, prec, batch, natural, kernel,
         a2a) in DIST_NODES:
        cls = getattr(dist_fft, client)
        problem = Problem(ext, kind, prec, batch)
        session = Session(TorchContext(device, {"dist_natural": natural}))
        t0 = time.perf_counter()
        _reset_counts()
        dfft.reset_collective_counts()
        rs = session.run(spec, nodes=[BenchNode(cls, problem)])
        counts = _read_counts()
        calls, sent = dfft.A2A_CALLS, dfft.A2A_BYTES
        val = rs.query(op="validate")
        if rs.failures() or len(val) != 1 or not val[0].success:
            raise AssertionError(f"{name} failed: "
                                 f"{[r.error for r in rs.failures()]}")
        launched = {k: c for k, (c, _) in counts.items() if c}
        if set(launched) != {kernel}:
            raise AssertionError(f"{name} should launch {kernel} and no "
                                 f"other, launched {launched}")
        if calls != runs * 2 * a2a:
            raise AssertionError(f"{name}: {calls} all_to_alls in {runs} "
                                 f"round trips, want {a2a} a direction")
        launches[kernel] += counts[kernel][0]
        for key, c in counts[kernel][1].items():
            shapes.setdefault(kernel, {}).setdefault(key, 0)
            shapes[kernel][key] += c
        med = lambda op: statistics.median(
            r.time_ms for r in rs.query(op=op) if r.run >= 0)
        node = {"dist_node": name, "client": client,
                "extents": "x".join(map(str, ext)), "kind": kind,
                "precision": prec, "batch": batch, "natural": natural,
                "backend": dist.get_backend(), "ranks": mesh.size,
                "execute_forward_ms": med("execute_forward"),
                "execute_inverse_ms": med("execute_inverse"),
                "a2a_calls": calls, "a2a_bytes": sent,
                "launches": launched}
        node["run_s"] = time.perf_counter() - t0
        del rs, session
        gc.collect()
        torch.cuda.empty_cache()
        node.update(_dist_spectrum(cls, problem, natural, kernel, device,
                                   gen))
        if node["a2a_per_forward"] != a2a:
            raise AssertionError(f"{name}: {node['a2a_per_forward']} "
                                 f"all_to_alls a forward, want {a2a}")
        node["node_s"] = time.perf_counter() - t0
        emit(node)
        gc.collect()
        torch.cuda.empty_cache()
    out = os.path.join(DIST_DIR, "BENCH_devices1_cuda.json")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench_grid.main(["--devices", "1", "--smoke", "--device",
                              str(device), "--out", out])
    with open(out) as f:
        doc = json.load(f)
    if rc != 0 or doc["meta"]["device_counts"] != [1]:
        raise AssertionError(f"bench_grid --devices 1: rc {rc}: "
                             f"{buf.getvalue()[-2000:]}")
    rows = []
    for r in doc["results"]:
        if r["backend"] not in bench_grid.DIST_BACKENDS:
            if not r["ok"]:
                raise AssertionError(f"bench_grid --devices 1: {r}")
            continue
        e = tuple(int(v) for v in r["extent"].split("x"))
        admitted = (
            (r["backend"] == "dist1d" and len(e) == 1
             and dfft.can_shard_1d(e[0], 1))
            or (r["backend"] == "slab" and len(e) in (2, 3)
                and dfft.slab_divisible(e, 1))
            or (r["backend"] == "pencil" and len(e) == 3
                and dfft.pencil_divisible(e, 1, 1)))
        if r["ok"] != admitted:
            raise AssertionError(f"bench_grid --devices 1: {r}")
        if r["ok"]:
            rows.append(f"{r['backend']}[{r['mesh']}]/{r['extent']} "
                        f"{r['time_ms']:.3f} ms, {r['collective_calls']} "
                        f"a2a, {r['collective_bytes']} B")
    emit({"bench_grid_devices_1": os.path.relpath(out, ROOT),
          "rows": len(doc["results"]), "dist_rows_ok": rows,
          "bench_grid_devices_s": time.perf_counter() - t0})
    emit({"main_path": "distributed transforms D1-D3 on one nccl rank",
          "launches": launches})
    dist.destroy_process_group()
    return {"launches": launches, "shapes": shapes}


def _lm_events(fn):
    """Call ``fn`` between two recorded CUDA events; returns its result
    and the (start, stop) pair, read after the run."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    return out, (start, stop)


def _lm_watch(model, finite: list) -> None:
    """Record, on the device, whether every logit of each prefill and
    decode step the engine runs is finite (read after the run)."""
    import torch

    def watch(fn):
        def wrapped(*args, **kwargs):
            logits, cache = fn(*args, **kwargs)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return wrapped
    model.prefill = watch(model.prefill)
    model.decode_step = watch(model.decode_step)


class _LastRoutes:
    """While open, records each MoE layer's routing of the last token of
    its input: the set of its top-k experts."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.rows = moe, moe._route, []
        moe._route = self._route

    def _route(self, router_w, x, top_k):
        out = self.real(router_w, x, top_k)
        self.rows.append(set(out[0][-1].tolist()))
        return out

    def close(self) -> list:
        self.moe._route = self.real
        return self.rows


def _lm_checks(device, label, cfg, params32, params16, prompt, token,
               image=None) -> tuple[dict, list]:
    """The float32 model (the engine's weights before the cast) decodes
    token ``len(prompt)`` after a prefill of ``prompt``, against column
    ``len(prompt)`` of the float32 forward (``LM_F32_TOL``, the same
    routing in every MoE layer); the bf16 forward against the float32 one
    (rel-L2, the share of positions whose argmax agrees); the bf16 decode
    against the bf16 forward's column, whose correlation must exceed
    ``LM_BF16_CORR``.  An MoE config runs with its capacity raised to
    n_experts / top_k, where no pass drops a token.  Its top-k routing is
    discontinuous, so where the bf16 decode routes the token to other
    experts than the bf16 forward in some layer, the bar is instead that
    the bf16 decode be no further from the float32 column than
    ``LM_MOE_BF16_RATIO`` times the bf16 forward's column is.  xlstm's
    decode (the recurrent form) against its forward (the chunked form)
    holds the correlation and the reference's max-abs bar ("bf16-scale
    noise": max abs < 0.5 at d 64, vocab 256, ``tests/test_arch_smoke.py``)
    in the scale of this model: the largest difference of the bf16 decode
    from the bf16 forward's column must be under the largest difference of
    that column from the float32 one.  It reports the difference in bf16
    spacings at the column's largest logit and in standard deviations of
    the column too.  ``image``:
    the vlm's image embeddings of one row (bf16).  Returns the numbers and
    the failed checks."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models.model import Model
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                  / cfg.top_k)
    s = prompt.shape[0]
    seq = torch.from_numpy(np.append(prompt, token).astype(np.int32))
    seq = seq[None].to(device)
    out, fwd, dec, differ = {}, {}, {}, {}
    for name, dtype, params in (("f32", torch.float32, params32),
                                ("bf16", torch.bfloat16, params16)):
        model = Model(dataclasses.replace(cfg, dtype=dtype), device=device)
        img = None if image is None else image.to(dtype)
        with torch.inference_mode():
            routes = _LastRoutes()
            try:
                full, _, _ = model.forward(params, seq, image_embeds=img)
            finally:
                full_routes = routes.close()
            cache = model.init_cache(1, s + 8)
            _, cache = model.prefill(params, seq[:, :s], cache,
                                     image_embeds=img)
            routes = _LastRoutes()
            try:
                step, _ = model.decode_step(params, seq[:, s:], cache, s,
                                            image_embeds=img)
            finally:
                dec_routes = routes.close()
        if not (torch.isfinite(full).all() and torch.isfinite(step).all()):
            raise AssertionError(f"{label} {name}: non-finite logits")
        fwd[name], dec[name] = full[0].float(), step[0, 0].float()
        differ[name] = [i for i, (a, b) in
                        enumerate(zip(full_routes, dec_routes)) if a != b]
        out[f"{name}_route_layers_differ"] = differ[name]
        del model, cache, full, step
    col32, col16 = fwd["f32"][s], fwd["bf16"][s]
    out["f32_decode_vs_forward_rel_l2"] = rel_l2(dec["f32"], col32)
    out["bf16_decode_vs_forward_corr"] = float(np.corrcoef(
        dec["bf16"].cpu().numpy(), col16.cpu().numpy())[0, 1])
    out["bf16_decode_vs_forward_max_abs"] = float(
        (dec["bf16"] - col16).abs().max())
    out["bf16_decode_vs_f32_column_rel_l2"] = rel_l2(dec["bf16"], col32)
    out["bf16_forward_vs_f32_column_rel_l2"] = rel_l2(col16, col32)
    out["bf16_vs_f32_forward_rel_l2"] = rel_l2(fwd["bf16"], fwd["f32"])
    out["bf16_vs_f32_argmax_agree"] = float(
        (fwd["bf16"].argmax(-1) == fwd["f32"].argmax(-1)).float().mean())
    failed = []
    if differ["f32"]:
        failed.append(f"float32 decode routes apart from the forward in "
                      f"layers {differ['f32']}")
    if not out["f32_decode_vs_forward_rel_l2"] <= LM_F32_TOL:
        failed.append(f"float32 decode against forward "
                      f"{out['f32_decode_vs_forward_rel_l2']:.3e} > "
                      f"{LM_F32_TOL}")
    out["bf16_logit_std"] = float(col16.std())
    out["bf16_column_max_abs_logit"] = float(col16.abs().max())
    spacing = torch.finfo(torch.bfloat16).eps \
        * 2.0 ** math.floor(math.log2(out["bf16_column_max_abs_logit"]))
    out["bf16_spacing_at_column_max"] = spacing
    out["bf16_decode_vs_forward_max_abs_spacings"] = \
        out["bf16_decode_vs_forward_max_abs"] / spacing
    out["bf16_decode_vs_forward_max_abs_per_std"] = \
        out["bf16_decode_vs_forward_max_abs"] / out["bf16_logit_std"]
    out["bf16_forward_vs_f32_column_max_abs"] = float(
        (col16 - col32).abs().max())
    if cfg.block_kind == "xlstm" and not \
            out["bf16_decode_vs_forward_max_abs"] \
            < out["bf16_forward_vs_f32_column_max_abs"]:
        failed.append(f"bf16 decode against forward max abs "
                      f"{out['bf16_decode_vs_forward_max_abs']} not under "
                      f"the bf16 forward's against float32 "
                      f"{out['bf16_forward_vs_f32_column_max_abs']}")
    if differ["bf16"] and not out["bf16_decode_vs_f32_column_rel_l2"] \
            <= LM_MOE_BF16_RATIO * out["bf16_forward_vs_f32_column_rel_l2"]:
        failed.append(f"bf16 decode {out['bf16_decode_vs_f32_column_rel_l2']:.3e}"
                      f" from the float32 column, over "
                      f"{LM_MOE_BF16_RATIO} x the bf16 forward's "
                      f"{out['bf16_forward_vs_f32_column_rel_l2']:.3e}")
    if not differ["bf16"] and \
            not out["bf16_decode_vs_forward_corr"] > LM_BF16_CORR:
        failed.append(f"bf16 decode against forward correlation "
                      f"{out['bf16_decode_vs_forward_corr']} <= "
                      f"{LM_BF16_CORR}")
    return out, failed


def _lm_device_events(prof) -> list:
    """(name, ms) of each device event of a finished ``torch.profiler``
    run.  It reads kineto's raw events (checked on torch 2.x): the public
    ``events()`` / ``key_averages()`` build a Python event for every host
    op too, which took 50 s for one xlstm prefill (70k kernels).  Without
    them it falls back to the public list."""
    from torch.autograd import DeviceType
    raw = getattr(getattr(prof.profiler, "kineto_results", None), "events",
                  None)
    if raw is None:
        return [(e.name, e.time_range.elapsed_us() / 1e3)
                for e in prof.events() if e.device_type == DeviceType.CUDA]
    return [(e.name(), e.duration_ns() / 1e6) for e in raw()
            if e.device_type() == DeviceType.CUDA]


def _lm_profile(fn, reps: int) -> dict:
    """``fn`` run ``reps`` times under ``torch.profiler`` (CPU and CUDA
    activity): per call, the wall ms (host clock to a synchronize), the
    device ms (the device events' durations), the device events and the
    heaviest five names.  Where ``reps`` > 1 (the decode steps, a few
    thousand events) the device ms is read through ``key_averages()`` as
    well, and the two readings must agree within 5%."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    busy, count, top, kinds = 0.0, 0, {}, {}
    for name, ms in _lm_device_events(prof):
        if name == "Activity Buffer Request":
            continue
        busy += ms / reps
        count += 1
        top[name[:60]] = top.get(name[:60], 0.0) + ms / reps
        kind = next((k for k, pattern in DEVICE_EVENT_KINDS
                     if re.search(pattern, name)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms / reps
    if not busy:
        raise AssertionError("torch.profiler saw no device time")
    out = {"wall_ms": wall, "device_ms": busy,
           "device_idle_share": max(0.0, 1.0 - busy / wall),
           "device_events": count / reps,
           "top": dict(sorted(top.items(), key=lambda kv: -kv[1])[:5]),
           "by_kind": dict(sorted(kinds.items(), key=lambda kv: -kv[1]))}
    if reps > 1:
        out["device_ms_key_averages"] = sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.key != "Activity Buffer Request") / 1e3 / reps
        if not abs(out["device_ms_key_averages"] - busy) <= 0.05 * busy:
            raise AssertionError(
                f"device ms {busy} from the raw events, "
                f"{out['device_ms_key_averages']} from key_averages()")
    return out


def _lm_cache_bytes(cache: dict) -> tuple[int, int]:
    """(bytes of the attention caches, which a dense decode reads whole;
    bytes of the recurrent states, which a step reads and writes)."""
    attention = state = 0
    for name, leaf in cache.items():
        if isinstance(leaf, dict):
            a, b = _lm_cache_bytes(leaf)
            attention, state = attention + a, state + b
        elif name in LM_ATTENTION_LEAVES:
            attention += leaf.numel() * leaf.element_size()
        else:
            state += leaf.numel() * leaf.element_size()
    return attention, state


def _lm_engine_run(label, engine, queue, max_new):
    """``main``'s loop over ``queue`` through ``ServeEngine``, each
    prefill and decode step between CUDA events.  Returns (prefill
    events, step events, steps)."""
    prefills, decodes = [], []
    pending = list(queue)
    steps = 0
    while pending or any(r is not None for r in engine.active):
        while pending and None in engine.active:
            ok, ev = _lm_events(lambda: engine.submit(pending[0]))
            if not ok:
                raise AssertionError(f"{label}: a free slot refused")
            prefills.append(ev)
            pending.pop(0)
        _, ev = _lm_events(engine.step)
        decodes.append(ev)
        steps += 1
        if steps > 10_000:
            raise AssertionError(f"{label}: the engine does not finish")
    if not all(r.done and len(r.out) == max_new for r in queue):
        raise AssertionError(f"{label}: requests not done with {max_new} "
                             f"tokens: {[len(r.out) for r in queue]}")
    return prefills, decodes, steps


def _lm_model_run(model, params, tokens, cache, image, max_new):
    """A batch through ``Model.prefill`` and ``max_new - 1`` greedy
    ``decode_step``s (the vlm's path: the engine passes no image
    embeddings), each between CUDA events.  Returns (prefill events, step
    events, the generated tokens (B, max_new))."""
    import torch
    last, ev = _lm_events(lambda: model.prefill(params, tokens, cache,
                                                image_embeds=image))
    prefills, decodes = [ev], []
    out = [last[0][:, -1].argmax(-1)]
    pos = tokens.shape[1]
    for _ in range(max_new - 1):
        (logits, _), ev = _lm_events(lambda: model.decode_step(
            params, out[-1][:, None].to(torch.int32), cache, pos,
            image_embeds=image))
        decodes.append(ev)
        out.append(logits[:, -1].argmax(-1))
        pos += 1
    return prefills, decodes, torch.stack(out, dim=1)


def _lm_cell(device, label, arch, n_layers, slots, max_len, n_requests,
             prompt_len, max_new) -> dict:
    """One architecture at full width (cut to ``n_layers`` where given):
    float32 weights from a seeded generator on the card, cast once to
    bf16; ``ServeEngine`` over ``main``'s prompts (``rng.integers``, seed
    0) and ``main``'s loop, or for the vlm ``Model.prefill`` /
    ``decode_step`` on a batch with seeded image embeddings; each prefill
    and decode step timed by CUDA events; then the checks."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models.model import Model
    from repro_torch.roofline.analysis import active_params

    t0 = time.perf_counter()
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    vlm = cfg.block_kind == "vlm"
    model32 = Model(dataclasses.replace(cfg, dtype=torch.float32),
                    device=device)
    gen = torch.Generator(device).manual_seed(0)
    params32 = model32.init_params(gen)
    if vlm:
        for unit in params32.units:
            unit.cross.gate.fill_(LM_CROSS_GATE)
    model = Model(cfg, device=device)
    finite: list = []
    _lm_watch(model, finite)
    n_params = sum(p.numel() for p in params32.parameters())
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (n_requests, prompt_len)).astype(np.int32)
    image = None
    if vlm:
        image = torch.randn((slots, cfg.n_image_tokens, cfg.d_model),
                            generator=gen, device=device).to(cfg.dtype)
        params16 = model.cast_params(params32)
        cache = model.init_cache(slots, max_len)
    else:
        engine = ServeEngine(model, params32, slots, max_len)
        params16, cache = engine.params, engine.cache
        queue = [Request(i, p, max_new) for i, p in enumerate(prompts)]
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    t_serve = time.perf_counter()
    if vlm:
        tokens = torch.from_numpy(prompts).to(device)
        with torch.inference_mode():
            prefills, decodes, out = _lm_model_run(
                model, params16, tokens, cache, image, max_new)
        steps = len(decodes)
        n_tokens = out.numel()
        first = int(out[0, 0])
    else:
        prefills, decodes, steps = _lm_engine_run(label, engine, queue,
                                                  max_new)
        n_tokens = sum(len(r.out) for r in queue)
        first = int(queue[0].out[0])
    torch.cuda.synchronize(device)
    serve_s = time.perf_counter() - t_serve
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"{label}: a non-finite logit while serving")
    del model.prefill, model.decode_step       # the watch's wrappers
    prompt = torch.from_numpy(prompts[:1]).to(device)
    pos = prompt_len + max_new - 1
    t_profile = time.perf_counter()
    with torch.inference_mode():
        if vlm:
            step_tokens = out[:, -1:].to(torch.int32)
            profiled = {
                "decode": _lm_profile(lambda: model.decode_step(
                    params16, step_tokens, cache, pos, image_embeds=image),
                    LM_PROFILED),
                "prefill": _lm_profile(lambda: model.prefill(
                    params16, tokens, cache, image_embeds=image), 1)}
        else:
            step_tokens = torch.from_numpy(engine.next_tok).to(device)
            profiled = {
                "decode": _lm_profile(lambda: model.decode_step(
                    params16, step_tokens, cache, pos), LM_PROFILED),
                "prefill": _lm_profile(lambda: engine._prefill_one(prompt,
                                                                   0), 1)}
    profile_s = time.perf_counter() - t_profile
    prefill_ms = statistics.median(a.elapsed_time(b) for a, b in prefills)
    decode_ms = statistics.median(a.elapsed_time(b) for a, b in decodes)

    total, active = active_params(cfg)
    tables = cfg.vocab_size * cfg.d_model * max(cfg.n_codebooks, 1)
    attention_bytes, state_bytes = _lm_cache_bytes(cache)
    bpe = torch.finfo(cfg.dtype).bits // 8
    # the vlm's cross layers read the image embeddings and project them
    # to K and V at every call (the reference's way)
    image_bytes = 0 if image is None else image.numel() * bpe
    cross_flops = 0 if image is None else (
        2 * image.shape[0] * cfg.n_image_tokens * cfg.d_model
        * 2 * cfg.n_kv_heads * cfg.head_dim * (cfg.n_layers
                                               // cfg.cross_every))
    # decode: the bf16 weights a token uses (the unembedding's table
    # once), the whole attention cache, which the dense decode reads, and
    # each recurrent state read and written once
    moved = attention_bytes + 2 * state_bytes + image_bytes
    decode_bound_ms = ((active + tables) * bpe + moved) \
        / HBM_BYTES_PER_S * 1e3
    decode_bound_all_ms = ((total + tables) * bpe + moved) \
        / HBM_BYTES_PER_S * 1e3
    # prefill: 2 N_active flops a token (the meta tokens included) and the
    # last token's unembedding, per request (the vlm: its batch at once)
    rows = slots if vlm else 1
    prefill_bound_ms = (rows * (2 * active * (prompt_len + cfg.n_meta_tokens)
                                + 2 * tables) + cross_flops) \
        / BF16_FLOPS * 1e3
    row = {"lm_serve": label, "arch": arch, "layers": cfg.n_layers,
           "dtype": str(cfg.dtype), "params": n_params,
           "active_params": active,
           "f32_weight_gb": n_params * 4 / 1e9,
           "bf16_weight_gb": n_params * bpe / 1e9,
           "cache_gb": (attention_bytes + state_bytes) / 1e9,
           "state_gb": state_bytes / 1e9, "slots": slots,
           "max_len": max_len, "requests": n_requests,
           "prompt_len": prompt_len, "max_new": max_new,
           "engine": "Model" if vlm else "ServeEngine",
           "engine_steps": steps, "tokens": n_tokens,
           "prefill_ms": prefill_ms, "prefill_bound_ms": prefill_bound_ms,
           "prefill_over_bound": prefill_ms / prefill_bound_ms,
           "decode_step_ms": decode_ms, "decode_bound_ms": decode_bound_ms,
           "decode_over_bound": decode_ms / decode_bound_ms,
           "decode_bound_all_experts_ms": decode_bound_all_ms,
           "tokens_per_s": n_tokens / serve_s, "serve_s": serve_s,
           "setup_s": setup_s, "profile_s": profile_s,
           "profiled": profiled, **card_info()}
    if not vlm:
        del engine
    del cache
    _free_card()
    t_checks = time.perf_counter()
    checks, failed = _lm_checks(device, label, cfg, params32, params16,
                                prompts[0], first,
                                None if image is None else image[:1])
    row.update(checks)
    row["checks_s"] = time.perf_counter() - t_checks
    emit(row)
    if failed:
        raise AssertionError(f"{label}: {'; '.join(failed)}")
    return row


def _free_card() -> None:
    """Free what the last cell left on the card."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def run_lm_serve(device, cells=LM_CELLS) -> dict:
    """The LM serving slice on the card: each of ``cells`` (rows of
    ``LM_CELLS``) at full width (``_lm_cell``), with the launch counts set
    to 0 just before and read just after (the LM path launches no FFT
    kernel).  TF32 must be off, as torch's default is, for the float32
    checks."""
    import torch
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the float32 checks "
                             "need full float32 products")
    _reset_counts()
    rows = {}
    for label, arch, n_layers, slots, max_len, n, prompt_len, max_new \
            in cells:
        t0 = time.perf_counter()
        rows[label] = _lm_cell(device, label, arch, n_layers, slots,
                               max_len, n, prompt_len, max_new)
        _free_card()
        emit({"lm_cell": label, "cell_s": time.perf_counter() - t0})
    launched = {k: c for k, (c, _) in _read_counts().items() if c}
    if launched:
        raise AssertionError(f"the LM path launched FFT kernels: {launched}")
    return rows


def _train_cell(device, label, arch, batch, seq, steps) -> dict:
    """One architecture at full width and depth: float32 parameters from
    a seeded generator on the card, bf16 compute, remat on; the step-0
    bf16 loss against the float32 one; (T1) the float32 gradient with
    remat against without at batch 1; then ``steps`` steps of
    ``build_train_step`` on ``SyntheticTokens``, each between two CUDA
    events, one more under ``torch.profiler``; the checks."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.model import Model
    from repro_torch.roofline.analysis import active_params
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.trainer import (build_train_step, upload,
                                           value_and_grad)

    t0 = time.perf_counter()
    cfg = get_config(arch)
    model = Model(cfg, device=device)
    model32 = Model(dataclasses.replace(cfg, dtype=torch.float32),
                    device=device)
    if not model.remat:
        raise AssertionError(f"{label}: remat is off")
    params = model.init_params(torch.Generator(device).manual_seed(0))
    n_params = sum(p.numel() for p in params.parameters())
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq, global_batch=batch,
                                      seed=0))
    batches = [upload(data.batch(i), device) for i in range(steps + 1)]
    failed = []
    with torch.no_grad():
        loss16 = float(model.loss_fn(params, batches[0])[1]["loss"])
        loss32 = float(model32.loss_fn(params, batches[0])[1]["loss"])
    bf16_rel = abs(loss16 - loss32) / abs(loss32)
    if not bf16_rel <= TRAIN_BF16_TOL:
        failed.append(f"bf16 step-0 loss {loss16} against float32 {loss32}")
    remat = {}
    if label == "T1":
        one = {"tokens": batches[0]["tokens"][:1]}
        _, with_remat = value_and_grad(model32, params, one)
        model32.remat = False
        _, without = value_and_grad(model32, params, one)
        worst, leaf = max((rel_l2(with_remat[k], without[k]), k)
                          for k in without)
        remat = {"remat_grad_rel_l2": worst, "remat_worst_leaf": leaf}
        if not worst <= TRAIN_REMAT_TOL:
            failed.append(f"remat gradient {leaf}: rel-L2 {worst}")
        del with_remat, without
    del model32
    _free_card()
    opt = init_opt_state(params)
    step_fn = build_train_step(model, OptConfig(
        lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=steps))
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(device)
    events, losses, norms = [], [], []
    t_train = time.perf_counter()
    for i in range(steps):
        (params, opt, metrics), ev = _lm_events(
            lambda: step_fn(params, opt, batches[i]))
        events.append(ev)
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
    torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t_train
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    step_ms = [a.elapsed_time(b) for a, b in events]
    t_profile = time.perf_counter()
    profiled = _lm_profile(lambda: step_fn(params, opt, batches[steps]), 1)
    profile_s = time.perf_counter() - t_profile
    if not all(math.isfinite(x) for x in losses + norms):
        failed.append(f"a non-finite loss or grad norm: {losses} {norms}")
    if not statistics.mean(losses[-3:]) < losses[0]:
        failed.append(f"the last three losses {losses[-3:]} are not below "
                      f"step 0's {losses[0]}")

    _, active = active_params(cfg)
    tokens = batch * seq
    flops = 6 * active * tokens
    median_ms = statistics.median(step_ms)
    bound_ms = (flops / BF16_FLOPS + ADAMW_BYTES * n_params
                / HBM_BYTES_PER_S) * 1e3
    row = {"train": label, "arch": arch, "layers": cfg.n_layers,
           "dtype": str(cfg.dtype), "remat": model.remat,
           "params": n_params, "active_params": active,
           "state_gb": 16 * n_params / 1e9, "batch": batch, "seq": seq,
           "steps": steps, "losses": losses, "grad_norms": norms,
           "loss0_bf16": loss16, "loss0_f32": loss32,
           "loss0_bf16_rel": bf16_rel, **remat,
           "step_ms": step_ms, "step_ms_median": median_ms,
           "wall_ms_per_step": train_s * 1e3 / steps,
           "tokens_per_s": tokens / (median_ms / 1e3),
           "bound_ms": bound_ms,
           "bound_flops_ms": flops / BF16_FLOPS * 1e3,
           "bound_adamw_ms": ADAMW_BYTES * n_params / HBM_BYTES_PER_S * 1e3,
           "over_bound": median_ms / bound_ms,
           "device_ms": profiled["device_ms"],
           "device_events": profiled["device_events"],
           "idle_share": max(0.0, 1.0 - profiled["device_ms"] / median_ms),
           "profiled": profiled, "peak_gb": peak_gb,
           "setup_s": setup_s, "profile_s": profile_s, **card_info()}
    emit(row)
    del params, opt, batches, step_fn
    _free_card()
    if failed:
        raise AssertionError(f"{label}: {'; '.join(failed)}")
    return row


def _train_restart(device, root: str) -> dict:
    """Reduced qwen3-1.7b at 2 layers in float32 through ``Trainer`` on
    the card: 2 steps, a checkpoint, a resume to step 4, against 4 steps
    straight: the final loss and every parameter within
    ``TRAIN_RESTART_TOL``."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(n_layers=2),
                              dtype=torch.float32)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      global_batch=4))
    shutil.rmtree(root, ignore_errors=True)

    def run(directory, steps):
        tcfg = TrainConfig(steps=steps, checkpoint_every=2,
                           checkpoint_dir=os.path.join(root, directory),
                           log_every=100, opt=OptConfig(
                               lr=TRAIN_LR, warmup_steps=1, total_steps=4))
        return Trainer(Model(cfg, device=device, remat=False), data,
                       tcfg).run(verbose=False)
    first = run("resumed", 2)
    resumed = run("resumed", 4)
    straight = run("straight", 4)
    worst, leaf = max(
        (rel_l2(a.detach(), b.detach()), name) for (name, a), b in
        zip(resumed["params"].named_parameters(),
            straight["params"].parameters()))
    loss_rel = abs(resumed["loss"] - straight["loss"]) / abs(straight["loss"])
    out = {"train_restart": "qwen3-1.7b reduced, 2 layers, float32",
           "steps": [first["step"], resumed["step"]],
           "loss": resumed["loss"], "loss_straight": straight["loss"],
           "loss_rel": loss_rel, "param_rel_l2": worst, "worst_leaf": leaf,
           "checkpoints": sorted(os.listdir(os.path.join(root, "resumed")))}
    emit(out)
    if not (resumed["step"] == 4 and worst <= TRAIN_RESTART_TOL
            and loss_rel <= TRAIN_RESTART_TOL):
        raise AssertionError(f"the restart on the card: {out}")
    return out


def _train_table(device) -> None:
    """The ``lm_steps`` table's eight clients through ``Session.run`` on
    the card: every node validated."""
    from repro_torch.benchmarks import table_lm_steps as tl
    from repro_torch.core.client import TorchContext
    from repro_torch.core.suite import Session

    rows = Session(TorchContext(device)).run(tl.SPEC).rows
    validate = {r.library: r for r in rows if r.op == "validate"}
    bad = {k: r.error for k, r in validate.items() if not r.success}
    if set(validate) != set(tl.SPEC.clients) or bad:
        raise AssertionError(f"lm_steps: {sorted(validate)} validated, "
                             f"failed {bad}")
    for lib in tl.SPEC.clients:
        ms = [r.time_ms for r in rows if r.library == lib
              and r.op == "execute_forward" and r.run >= 0]
        emit({"lm_steps": lib, "execute_forward_ms": ms,
              "init_forward": [r.plan_cache for r in rows if r.library == lib
                               and r.op == "init_forward"]})


def run_train(device, cells=TRAIN_CELLS) -> dict:
    """The LM training slice on the card: each of ``cells`` (``_train_cell``),
    the checkpoint restart and the ``lm_steps`` table, with the launch
    counts set to 0 just before and read just after (the training path
    launches no FFT kernel)."""
    import torch
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the float32 checks "
                             "need full float32 products")
    _reset_counts()
    rows = {}
    for label, arch, batch, seq, steps in cells:
        t0 = time.perf_counter()
        rows[label] = _train_cell(device, label, arch, batch, seq, steps)
        emit({"train_cell": label, "cell_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    rows["restart"] = _train_restart(device, os.path.join(ROOT, "build",
                                                          "train_ckpt"))
    _train_table(device)
    emit({"train_checks_s": time.perf_counter() - t0})
    launched = {k: c for k, (c, _) in _read_counts().items() if c}
    if launched:
        raise AssertionError(f"the training path launched FFT kernels: "
                             f"{launched}")
    return rows


#: M1/M2's model, batch and sequence (T1's), sharded steps, decode steps
SHARDED_ARCH, SHARDED_BATCH, SHARDED_SEQ = "qwen3-1.7b", 8, 512
SHARDED_STEPS, SHARDED_DECODE = 3, 8
#: M1's step-0 loss against the unsharded model's, relative
SHARDED_LOSS_TOL = 1e-5
#: M2's float32 logits against the unsharded model's, rel-L2 (the LM
#: phase's decode bar)
SHARDED_LOGITS_TOL = 1e-4
#: the dry-run cells at 16x16: (arch, shape)
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k"),
                ("granite-moe-1b-a400m", "train_4k"),
                ("starcoder2-7b", "prefill_32k"))


def _all_dtensors(tree) -> bool:
    from torch.distributed.tensor import DTensor

    from repro_torch.models.convert import named_tensors
    return all(isinstance(t, DTensor) for t in named_tensors(tree).values())


def _sharded_train(device, t1: dict | None) -> dict:
    """M1: qwen3-1.7b on a (1, 1) mesh, T1's weights and batches."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.roofline.analysis import active_params
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.trainer import build_train_step, upload

    t0 = time.perf_counter()
    cfg = get_config(SHARDED_ARCH)
    mesh = make_mesh((1, 1), ("data", "model"))
    model = Model(cfg, mesh=mesh, device=device, remat=True)
    plain = Model(cfg, device=device, remat=True)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=SHARDED_SEQ,
                                      global_batch=SHARDED_BATCH, seed=0))
    steps = SHARDED_STEPS
    batches = [upload(data.batch(i), device) for i in range(steps + 1)]
    with torch.no_grad():
        params = plain.init_params(torch.Generator(device).manual_seed(0))
        loss_plain = float(plain.loss_fn(params, batches[0])[1]["loss"])
        del params
    _free_card()
    params = model.init_params(torch.Generator(device).manual_seed(0))
    opt = init_opt_state(params)
    failed = []
    if not (_all_dtensors(params) and _all_dtensors(opt["m"])
            and _all_dtensors(opt["v"])):
        failed.append("a parameter or moment is not a DTensor")
    n_params = sum(p.numel() for p in params.parameters())
    step_fn = build_train_step(model, OptConfig(
        lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=2 * steps))
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(device)
    events, losses = [], []
    for i in range(steps):
        (params, opt, metrics), ev = _lm_events(
            lambda: step_fn(params, opt, batches[i]))
        events.append(ev)
        losses.append(metrics["loss"])
    torch.cuda.synchronize(device)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    losses = [float(x) for x in losses]
    step_ms = [a.elapsed_time(b) for a, b in events]
    profiled = _lm_profile(lambda: step_fn(params, opt, batches[steps]), 1)
    loss_rel = abs(losses[0] - loss_plain) / abs(loss_plain)
    if not loss_rel <= SHARDED_LOSS_TOL:
        failed.append(f"step-0 loss {losses[0]} against the unsharded "
                      f"{loss_plain}")
    if not all(math.isfinite(x) for x in losses):
        failed.append(f"a non-finite loss: {losses}")
    del opt, step_fn, batches
    _free_card()

    _, active = active_params(cfg)
    tokens = SHARDED_BATCH * SHARDED_SEQ
    flops = 6 * active * tokens
    median_ms = statistics.median(step_ms)
    bound_ms = (flops / BF16_FLOPS + ADAMW_BYTES * n_params
                / HBM_BYTES_PER_S) * 1e3
    row = {"sharded": "M1", "arch": SHARDED_ARCH, "mesh": "1x1",
           "params": n_params, "batch": SHARDED_BATCH, "seq": SHARDED_SEQ,
           "losses": losses, "loss0_unsharded": loss_plain,
           "loss0_rel": loss_rel, "step_ms": step_ms,
           "step_ms_median": median_ms,
           "tokens_per_s": tokens / (median_ms / 1e3),
           "bound_ms": bound_ms, "over_bound": median_ms / bound_ms,
           "device_ms": profiled["device_ms"],
           "device_events": profiled["device_events"],
           "idle_share": max(0.0, 1.0 - profiled["device_ms"] / median_ms),
           "profiled": profiled, "peak_gb": peak_gb, "setup_s": setup_s,
           **card_info()}
    if t1:
        row["t1"] = {k: t1[k] for k in ("step_ms_median", "tokens_per_s",
                                        "device_ms", "device_events",
                                        "idle_share", "peak_gb")}
        row["step_over_t1"] = median_ms / t1["step_ms_median"]
        row["host_ms_over_t1"] = median_ms - t1["step_ms_median"]
    emit(row)
    if failed:
        raise AssertionError(f"M1: {'; '.join(failed)}")
    return {"row": row, "model": model, "plain": plain, "params": params}


def _sharded_checkpoint(device, m1: dict) -> None:
    """M1's parameters saved from the sharded run restore into the
    unsharded model with equal leaves; then ``launch.train --mesh 1x1
    --reduced`` on the same one-rank group."""
    import torch

    from repro_torch.launch import train as launch_train
    from repro_torch.train.checkpoint import CheckpointManager

    plain, params = m1["plain"], m1["params"]
    steps = SHARDED_STEPS
    failed = []
    t_ck = time.perf_counter()
    ckdir = os.path.join(ROOT, "build", "sharded_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    ckpt = CheckpointManager(ckdir, keep=1)
    ckpt.save(steps + 1, params)
    template = plain._build(None)
    template = template.to_empty(device=device)
    restored, _, manifest = ckpt.restore(template)
    mine = dict(params.named_parameters())
    mismatched = [k for k, p in restored.named_parameters()
                  if not torch.equal(p, mine[k].to_local())]
    if manifest["step"] != steps + 1 or mismatched:
        failed.append(f"the sharded checkpoint restores unequal leaves: "
                      f"{mismatched[:3]}")
    del restored, template
    shutil.rmtree(ckdir, ignore_errors=True)
    ckpt_s = time.perf_counter() - t_ck
    del params, mine
    _free_card()

    # the launcher on the same one-rank group
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(["--reduced", "--steps", "2", "--batch", "4",
                                "--seq", "32", "--mesh", "1x1",
                                "--checkpoint-dir",
                                os.path.join(ROOT, "build", "m1_launch"),
                                "--checkpoint-every", "2"])
    shutil.rmtree(os.path.join(ROOT, "build", "m1_launch"),
                  ignore_errors=True)
    if rc != 0 or "[train] finished at step 2" not in out.getvalue():
        failed.append(f"launch.train --mesh 1x1: {out.getvalue()[-300:]}")

    emit({"sharded_checkpoint_s": ckpt_s, "launch_train_mesh_1x1": rc})
    if failed:
        raise AssertionError(f"M1 checkpoint: {'; '.join(failed)}")


def _sharded_serve(device) -> dict:
    """M2: the same model on the same mesh, a prefill and decode steps;
    the float32 logits against the unsharded model's, the bf16 decode
    step's ms against the unsharded one's."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model

    cfg = get_config(SHARDED_ARCH)
    mesh = make_mesh((1, 1), ("data", "model"))
    gen = torch.Generator(device).manual_seed(3)
    b, s, n = SHARDED_BATCH, SHARDED_SEQ, SHARDED_DECODE
    tokens = torch.randint(0, cfg.vocab_size, (b, s + n), generator=gen,
                           device=device, dtype=torch.int32)
    failed, worst, ms = [], 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, dtype=dtype)
        logits = {}
        for name, model in (("plain", Model(c, device=device)),
                            ("sharded", Model(c, mesh=mesh, device=device))):
            params = model.init_params(
                torch.Generator(device).manual_seed(0))
            params = model.cast_params(params)
            with torch.no_grad():
                cache = model.init_cache(b, s + n)
                lg, cache = model.prefill(params, tokens[:, :s], cache)
                outs = [lg]
                times = []
                for t in range(n):
                    (lg, cache), ev = _lm_events(
                        lambda: model.decode_step(params, tokens[:, s + t:
                                                               s + t + 1],
                                                  cache, s + t))
                    times.append(ev)
                    outs.append(lg)
                torch.cuda.synchronize(device)
            logits[name] = torch.cat(
                [o.full_tensor() if isinstance(o, DTensor) else o
                 for o in outs], dim=1).float()
            if dtype == torch.bfloat16:
                ms[name] = statistics.median(a.elapsed_time(z)
                                             for a, z in times[1:])
            del params, cache, outs
            _free_card()
        if dtype == torch.float32:
            worst = rel_l2(logits["sharded"], logits["plain"])
            if not worst <= SHARDED_LOGITS_TOL:
                failed.append(f"float32 logits rel-L2 {worst}")
        if not torch.isfinite(logits["sharded"]).all():
            failed.append(f"non-finite {dtype} logits")
        del logits
    row = {"sharded": "M2", "arch": SHARDED_ARCH, "mesh": "1x1",
           "batch": b, "prompt": s, "decode_steps": n,
           "logits_f32_rel_l2": worst,
           "decode_ms_bf16_sharded": ms["sharded"],
           "decode_ms_bf16_plain": ms["plain"],
           "decode_over_plain": ms["sharded"] / ms["plain"], **card_info()}
    emit(row)
    if failed:
        raise AssertionError(f"M2: {'; '.join(failed)}")
    return row


#: child processes still running (``_stop_children`` ends them)
_CHILDREN: list = []


def _stop_children() -> None:
    while _CHILDREN:
        p = _CHILDREN.pop()
        if p.poll() is None:
            p.kill()
        p.wait()


def start_dryrun() -> dict:
    """Start the dry run's cells at 16x16, one child process each (a fake
    group is its process's default group), all together; they trace on
    the host while the card's phases run on; ``finish_dryrun`` reads
    them."""
    out_dir = os.path.join(ROOT, "build", "dryrun")
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out-dir", out_dir], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch, shape in DRYRUN_CELLS]
    _CHILDREN.extend(procs)
    return {"procs": procs, "out_dir": out_dir, "t0": time.perf_counter()}


def finish_dryrun(started: dict) -> dict:
    """Wait for the dry run's cells: every record ok, printed as counts,
    and the roofline table rendered."""
    from repro_torch.roofline import analysis

    procs, out_dir = started["procs"], started["out_dir"]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        _stop_children()
    wall = time.perf_counter() - started["t0"]
    records = {}
    for (arch, shape), p, log in zip(DRYRUN_CELLS, procs, logs):
        path = os.path.join(out_dir, f"{arch}_{shape}_16-16.json")
        rec = json.load(open(path)) if os.path.exists(path) else {}
        if p.returncode != 0 or rec.get("status") != "ok":
            raise AssertionError(f"dry run {arch} {shape}: rc "
                                 f"{p.returncode}, {rec.get('status')}: "
                                 f"{rec.get('trace', log[-2000:])}")
        coll = rec["collectives"]
        emit({"dryrun": f"{arch} {shape}", "mesh": rec["mesh"],
              "mode": rec["mode"], "trace_s": rec["lower_s"],
              "argument_gib_per_device":
                  rec["memory"]["argument_size_in_bytes"] / 2**30,
              "flops_per_device": rec["flops_per_device"],
              "dot_bytes_per_device": rec["dot_bytes_per_device"],
              "collective_mib_by_kind": {k: v / 2**20 for k, v in
                                         coll["by_kind"].items()},
              "collective_counts": coll["counts"],
              "collective_mib_by_axis": {
                  a: {k: v / 2**20 for k, v in kinds.items()}
                  for a, kinds in coll["by_axis"].items()}})
        records[(arch, shape)] = rec
    table = analysis.markdown_table(analysis.load_rows(out_dir, "16x16"))
    print(table, flush=True)
    emit({"dryrun_wall_s": wall})
    return records


def run_sharded(device, t1: dict | None = None) -> tuple[dict, dict]:
    """M1, M2 on a one-rank ``nccl`` group (destroyed after), the launch
    counts set to 0 before and read after (the LM path launches no FFT
    kernel); the dry run's cells start after M1's timed steps.  Returns
    (the rows, the started dry run for ``finish_dryrun``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import ensure_default_group

    _reset_counts()
    ensure_default_group(device)
    started = None
    try:
        if dist.get_world_size() != 1:
            raise AssertionError("M1/M2 need a one-rank group")
        t0 = time.perf_counter()
        m1 = _sharded_train(device, t1)
        rows = {"M1": m1["row"]}
        emit({"sharded_train_s": time.perf_counter() - t0})
        # the dry run's host-only traces beside the untimed checks and M2
        # (M2's two decode times share the same host)
        started = start_dryrun()
        t0 = time.perf_counter()
        _sharded_checkpoint(device, m1)
        del m1
        _free_card()
        rows["M2"] = _sharded_serve(device)
        emit({"sharded_serve_s": time.perf_counter() - t0})
    finally:
        dist.destroy_process_group()
    launched = {k: c for k, (c, _) in _read_counts().items() if c}
    if launched:
        raise AssertionError(f"the sharded LM path launched FFT kernels: "
                             f"{launched}")
    return rows, started


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
    t_serve = time.perf_counter()
    serve = run_serve(device)
    emit({"serve_phase_s": time.perf_counter() - t_serve})
    t_dist = time.perf_counter()
    dist_path = run_distributed(device)
    emit({"dist_phase_s": time.perf_counter() - t_dist})
    t_lm = time.perf_counter()
    run_lm_serve(device)
    emit({"lm_serve_phase_s": time.perf_counter() - t_lm})
    t_train = time.perf_counter()
    trained = run_train(device)
    emit({"train_phase_s": time.perf_counter() - t_train})
    t_sharded = time.perf_counter()
    _, dryrun = run_sharded(device, trained.get("T1"))
    emit({"sharded_phase_s": time.perf_counter() - t_sharded})
    main_path["launches"]["dft_matmul"] = planner["launches"]
    main_path["shapes"]["dft_matmul"] = planner["shapes"]
    for kernel, n in dist_path["launches"].items():
        main_path["launches"][kernel] = main_path["launches"].get(kernel,
                                                                  0) + n
    t_conv = time.perf_counter()
    checks[("fftconv", "float32")] = check_fftconv(device)
    conv = run_fftconv_path(device)
    emit({"fftconv_phases_s": time.perf_counter() - t_conv})
    main_path["launches"]["fftconv"] = conv["launches"]["fftconv"]
    main_path["shapes"]["fftconv"] = conv["shapes"]["fftconv"]
    for kernel, n in serve["launches"].items():
        main_path["launches"][kernel] += n
    checked = {k: dict(v) for k, v in main_path["shapes"].items()}
    others = {k: v for k, v in conv["shapes"].items() if k != "fftconv"}
    for sweep in planner["sweep_shapes"] + [others, backends["shapes"],
                                            serve["shapes"],
                                            dist_path["shapes"]]:
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
    t_dry = time.perf_counter()
    finish_dryrun(dryrun)
    emit({"dryrun_wait_s": time.perf_counter() - t_dry})

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
    try:
        sys.exit(main())
    finally:
        _stop_children()
