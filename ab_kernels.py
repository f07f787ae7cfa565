"""Time the port's hand-written kernels of one source tree on one GPU.

    python3 ab_kernels.py SRC_DIR LABEL

SRC_DIR is the ``src/`` of a checkout (this one, or a parent unpacked
with ``git archive`` into ``build/``).  Prints one JSON line: the median
of 50 CUDA-event times (after 3 warm calls) of each kernel on prepared
operands at the main path's shapes: the fft2 kernel at P7's and P6's
tiles, the Stockham kernel at P7's axis and P3, the four-step kernel at
the axes of P1-P7 (complex64 and complex128), the dft kernel at P8 and
P9's packed axis, and
the fused fftconv kernel at F2 and F3 (the default tile); and the real
transforms of the main path, forward and inverse: the fft2 kernel's fold
at P6 (rfft2 of 128 x 128 x 8192 float32) and the Stockham kernel's at
P1's inner axis (rfft of 256 x 65536) and P5 (945 x 65536).  A tree whose
wrappers have no fold (``rfft`` / ``rfft2``: before they were folded into
the kernels) times its ``fft/rfft.py`` packing around its kernel instead,
under the same names.  Inputs are made on the card from a fixed seed.  To compare two trees, run it on
each in turns (A, B, B, A) in one call, one process per run.  (Before
the four-step and fftconv redesign it timed only fft2, Stockham and the
four-step kernel at P3, under the name ``ab_fft2.py``.)
"""
from __future__ import annotations

import json
import math
import statistics
import sys

import torch

#: (n1, n2, dtype) of the fft2 kernel: P7's and P6's engine tiles, 8192 each
FFT2_SHAPES = ((64, 64, torch.complex128), (128, 64, torch.complex64))
#: (n, rows, dtype) of the Stockham kernel
STOCKHAM_SHAPES = ((64, 524288, torch.complex128),
                   (4096, 16384, torch.complex64))
#: (n, rows, dtype) of the four-step kernel on the main path: P3, P5's
#: packed axis, P1's packed inner and outer axes, P4's packed and outer
#: axes, P2's and P7's axes
FOURSTEP_SHAPES = ((4096, 16384, torch.complex64),
                   (945, 65536, torch.complex64),
                   (128, 65536, torch.complex64),
                   (256, 33024, torch.complex64),
                   (1536, 3072, torch.complex64),
                   (3072, 1537, torch.complex64),
                   (128, 16384, torch.complex128),
                   (64, 524288, torch.complex128))
#: (n, rows, dtype) of the dft kernel: P8, and P9's packed axis
DFT_SHAPES = ((128, 524288, torch.complex64), (50, 655360, torch.complex128))
#: (name, channels, signals, L = K) of the fused fftconv kernel
CONV_SHAPES = (("F2", 768, 32, 2048), ("F3", 768, 8, 8192))
#: (n, rows) of the Stockham kernel's real fold (float32): P1's inner
#: axis, P5; (n1, n2, signals) of the fft2 kernel's: P6
FOLD_SHAPES = ((256, 65536), (945, 65536))
FOLD2_SHAPES = ((128, 128, 8192),)


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
    from repro_torch.kernels.dft_matmul import ops as dft
    from repro_torch.kernels.fft2_pallas import ops as f2
    from repro_torch.kernels.fft4step import ops as fs
    from repro_torch.kernels.fftconv import ops as conv
    from repro_torch.kernels.stockham_pallas import ops as sp

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    row = {"label": label}

    def rand(shape, dtype):
        return torch.randn(shape, dtype=dtype, device=dev, generator=gen)

    for n1, n2, dt in FFT2_SHAPES:
        x = rand((8192, n1, n2), dt)
        tw = f2.make_twiddles2(n1, n2, 8, False, dt, dev)
        row[f"fft2 {n1}x{n2} {dt}"] = median_ms(
            lambda: f2.fft2(x, False, twiddles=tw))
        del x
    for n, rows, dt in STOCKHAM_SHAPES:
        x = rand((rows, n), dt)
        tw = sp.make_twiddles(n, 8, False, dt, dev)
        row[f"stockham {n}x{rows} {dt}"] = median_ms(
            lambda: sp.fft(x, False, twiddles=tw))
        del x
    for n, rows, dt in FOURSTEP_SHAPES:
        x = rand((rows, n), dt)
        tables = fs.make_tables(n, False, dt, dev)
        row[f"fourstep {n}x{rows} {dt}"] = median_ms(
            lambda: fs.fft(x, False, twiddles=tables))
        del x
    for n, rows, dt in DFT_SHAPES:
        x = rand((rows, n), dt)
        m = dft.make_matrix(n, False, dt, dev)
        row[f"dft {n}x{rows} {dt}"] = median_ms(
            lambda: dft.dft(x, False, matrix=m))
        del x
    for name, c, b, L in CONV_SHAPES:
        x = rand((c, b, L), torch.float32)
        h = rand((c, L), torch.float32) / math.sqrt(L)
        op = conv.prepare(x, h)
        row[f"fftconv {name}"] = median_ms(lambda: conv.run_kernel(op))
        del x, h, op
    time_folds(row, sp, f2, rand)
    torch.cuda.empty_cache()
    print(json.dumps(row), flush=True)


def time_folds(row: dict, sp, f2, rand) -> None:
    """The main path's real transforms: the kernels' folds, or (a tree
    without them) ``fft/rfft.py``'s packing around the kernel."""
    from repro_torch.fft import rfft as rfft_mod
    from repro_torch.fft.reference import half_roots

    dev = torch.device("cuda", 0)
    c64 = torch.complex64
    for n, rows in FOLD_SHAPES:
        x = rand((rows, n), torch.float32)
        m = n // 2 if n % 2 == 0 else n
        fwd = sp.make_twiddles(m, 8, False, c64, dev)
        inv = sp.make_twiddles(m, 8, True, c64, dev)
        rf = half_roots(n, False, c64, device=dev) if n % 2 == 0 else None
        ri = half_roots(n, True, c64, device=dev) if n % 2 == 0 else None
        bins = torch.fft.rfft(x)
        if hasattr(sp, "rfft"):
            f = lambda: sp.rfft(x, twiddles=fwd, roots=rf)
            g = lambda: sp.irfft(bins, n, twiddles=inv, roots=ri)
        else:
            f = lambda: rfft_mod.rfft(x, lambda z: sp.fft(
                z, twiddles=fwd), rf)
            g = lambda: rfft_mod.irfft(bins, n, lambda z, inverse=False: sp.fft(
                z, True, twiddles=inv), ri)
        row[f"rfft {n}x{rows} float32"] = median_ms(f)
        row[f"irfft {n}x{rows} float32"] = median_ms(g)
        del x, bins
    for n1, n2, sigs in FOLD2_SHAPES:
        x = rand((sigs, n1, n2), torch.float32)
        fwd = f2.make_twiddles2(n1, n2 // 2, 8, False, c64, dev)
        inv = f2.make_twiddles2(n1, n2 // 2, 8, True, c64, dev)
        rf = half_roots(n2, False, c64, device=dev)
        ri = half_roots(n2, True, c64, device=dev)
        bins = torch.fft.rfft2(x)
        if hasattr(f2, "rfft2"):
            f = lambda: f2.rfft2(x, twiddles=fwd, roots=rf)
            g = lambda: f2.irfft2(bins, n2, twiddles=inv, roots=ri)
        else:
            f = lambda: rfft_mod.rfftn_packed(x, lambda z: f2.fft2(
                z, twiddles=fwd), 2, rf)
            g = lambda: rfft_mod.irfftn_packed(
                bins, (n1, n2), lambda z, inverse=False: f2.fft2(
                    z, True, twiddles=inv), ri)
        row[f"rfft2 {n1}x{n2}x{sigs} float32"] = median_ms(f)
        row[f"irfft2 {n1}x{n2}x{sigs} float32"] = median_ms(g)
        del x, bins


if __name__ == "__main__":
    main()
