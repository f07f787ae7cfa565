"""Time the fft2, Stockham and four-step kernels of one source tree on
one GPU.

    python3 ab_fft2.py SRC_DIR LABEL

SRC_DIR is the ``src/`` of a checkout (this one, or a parent unpacked
with ``git archive`` into ``build/``).  Prints one JSON line: the median
of 50 CUDA-event times (after 3 warm calls) of the fft2 kernel at the
main path's P7 and P6 shapes, and of the Stockham and four-step kernels
at 64 x 524288 complex128 and 4096 x 16384 complex64.  To compare two
trees, run it on each in turns (A, B, B, A) in one call, one process per
run.
"""
from __future__ import annotations

import json
import statistics
import sys

import torch

#: (n1, n2, dtype) of the fft2 kernel: P7's and P6's engine tiles, 8192 each
FFT2_SHAPES = ((64, 64, torch.complex128), (128, 64, torch.complex64))
#: (n, rows, dtype) of the Stockham and four-step kernels
STOCKHAM_SHAPES = ((64, 524288, torch.complex128),
                   (4096, 16384, torch.complex64))


def median_ms(fn, reps: int = 50) -> float:
    """Median of ``reps`` CUDA-event times of ``fn`` after 3 warm calls."""
    for _ in range(3):
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


def main() -> None:
    src, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, src)
    from repro_torch.kernels.fft2_pallas import ops as f2
    from repro_torch.kernels.fft4step import ops as fs
    from repro_torch.kernels.stockham_pallas import ops as sp

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    row = {"label": label}
    for n1, n2, dt in FFT2_SHAPES:
        x = torch.randn((8192, n1, n2), dtype=dt, device=dev, generator=gen)
        tw = f2.make_twiddles2(n1, n2, 8, False, dt, dev)
        row[f"fft2 {n1}x{n2} {dt}"] = median_ms(
            lambda: f2.fft2(x, False, twiddles=tw))
        del x
    for n, rows, dt in STOCKHAM_SHAPES:
        x = torch.randn((rows, n), dtype=dt, device=dev, generator=gen)
        tw = sp.make_twiddles(n, 8, False, dt, dev)
        row[f"stockham {n}x{rows} {dt}"] = median_ms(
            lambda: sp.fft(x, False, twiddles=tw))
        tables = fs.make_tables(n, False, dt, dev)
        row[f"fourstep {n}x{rows} {dt}"] = median_ms(
            lambda: fs.fft(x, False, twiddles=tables))
        del x
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
