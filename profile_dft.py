"""Sweep the dft kernel's chirp body on one GPU: the split of its chirp
length and its rows a warp.

    python3 profile_dft.py [--out build/dft_profile/profile.jsonl]

The chirp body (``csrc/dft.cu``, ``dft_chirp_kernel``) transforms a row
of n points as a circular convolution at a length m = m1 * m2 >= 2n - 1;
``dft_matmul.chirp_split`` picks the split of the fewest flops and
``chirp_rows_per_warp`` the rows a warp owns.  This script builds a copy
of the kernel source under ``build/dft_profile/`` with the repository's
nvcc flags and the splits of ``CASES`` added to ``DFT_CHIRP_SPLITS``,
prints ptxas's registers and spills of every chirp instantiation, and
times the body (CUDA events, median of 30 after 3 warm calls, the
library's entry called directly) on 512 MiB of rows at each n of
``CASES``: at each split listed there (the chosen one first), each at
1/2, 1, 3/2 and 2 times the chosen rows a warp where one block holds
them, beside ``torch.fft``.  Every output is held against ``torch.fft``
(1e-3 / 1e-8 rel-L2) and the split's plain model ``ref.apply_chirp``
(1e-5 / 1e-12) on its first 2000 rows.  Prints one JSON object a line
(the card's name and power limit first) and writes them to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.dft_matmul import dft_matmul as dm  # noqa: E402
from repro_torch.kernels.dft_matmul import ops, ref  # noqa: E402

#: (n, dtype, splits): the chosen split and others with m >= 2n - 1 (the
#: smallest m, and cheaper radices at a larger m)
CASES = ((11, torch.complex64, ((3, 8), (3, 7), (4, 6), (4, 8))),
         (19, torch.complex64, ((5, 8), (6, 8), (8, 8), (5, 9))),
         (67, torch.complex64, ((9, 16), (9, 15), (12, 12), (10, 16),
                                (16, 16))),
         (127, torch.complex64, ((16, 16),)),
         (19, torch.complex128, ((5, 8), (8, 8))),
         (127, torch.complex128, ((16, 16),)))
BUILD = os.path.join(ROOT, "build", "dft_profile")


def build(emit) -> ctypes.CDLL:
    """The kernel source with every split of ``CASES``, built by nvcc."""
    shutil.rmtree(BUILD, ignore_errors=True)
    os.makedirs(BUILD)
    for name in ("dft.cu", "reg_fft.cuh", "stockham_stages.cuh"):
        shutil.copy(_build.CSRC / name, BUILD)
    path = os.path.join(BUILD, "dft.cu")
    src = open(path).read()
    start = src.index("#define DFT_CHIRP_SPLITS(X)")
    have = set(re.findall(r"X\((\d+), (\d+)\)",
                          src[start:src.index("\n\n", start)]))
    extra = sorted({s for _, _, splits in CASES for s in splits
                    if (str(s[0]), str(s[1])) not in have})
    head = "#define DFT_CHIRP_SPLITS(X)"
    src = src.replace(head, head + " " + " ".join(
        f"X({a}, {b})" for a, b in extra), 1)
    open(path, "w").write(src)
    lib = os.path.join(BUILD, "libdft.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    rows, entry, frame = [], None, None
    for line in (proc.stderr + proc.stdout).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = [int(v) for v in m.groups()]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and "dft_chirp_kernel" in entry:
            t = re.search(r"dft_chirp_kernelI(\w)Li(\d+)ELi(\d+)E", entry)
            rows.append([t.group(1), f"{t.group(2)}x{t.group(3)}",
                         int(m.group(1)), *frame])
            entry = None
    emit({"ptxas": rows, "spills": [r for r in rows if r[4] or r[5]]})
    return ctypes.CDLL(lib)


def median_ms(fn, reps: int = 30) -> float:
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


def sweep(emit, lib: ctypes.CDLL, n: int, dtype: torch.dtype,
          splits) -> None:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(n)
    item = 16 if dtype == torch.complex128 else 8
    rows = (1 << 29) // (n * item)
    x = torch.randn((rows, n), dtype=dtype, device=dev, generator=gen)
    y = torch.empty_like(x)
    fn = lib.dft_chirp_f64 if item == 16 else lib.dft_chirp_f32
    c = ctypes
    fn.argtypes = [c.c_void_p] * 3 + [c.c_longlong] + [c.c_int] * 8 \
        + [c.c_void_p]
    fn.restype = c.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    want = torch.fft.fft(x[:2000])
    chosen = dm.chirp_rows_per_warp(n)
    base = {"n": n, "rows": rows, "dtype": str(dtype).removeprefix("torch."),
            "chosen": "x".join(map(str, dm.chirp_split(n))),
            "chosen_rows_per_warp": chosen,
            "bound_ms": 2 * x.numel() * item / 3.35e12 * 1e3,
            "fft_ms": median_ms(lambda: torch.fft.fft(x))}
    for m1, m2 in splits:
        m = m1 * m2
        tab = ops.chirp_table(n, m, dtype, dev)
        plain = ref.apply_chirp(x[:2000], tab[:m], tab[m:m + n], tab[m + n:],
                                m1, m2, False)
        times = {}
        for rpw in sorted({max(1, chosen // 2), chosen, chosen * 3 // 2,
                           2 * chosen}):
            pitch, rs = dm.slice_layout(m1, m2, rpw, item)
            if rpw > 32 or dm.FFT_WARPS * rpw * (rs + n) * item \
                    > ops.SMEM_LIMIT_BYTES:
                continue
            call = lambda: fn(x.data_ptr(), y.data_ptr(), tab.data_ptr(),
                              rows, n, m1, m2, dm.FFT_WARPS * rpw, rpw,
                              pitch, rs, 0, stream)
            if call() != 0:
                raise RuntimeError(f"launch failed: n={n} {m1}x{m2} "
                                   f"rows a warp {rpw}")
            torch.cuda.synchronize(dev)
            e_lib = float((y[:2000] - want).norm() / want.norm())
            e_plain = float((y[:2000] - plain).norm() / plain.norm())
            if not (e_lib <= (1e-3 if item == 8 else 1e-8)
                    and e_plain <= (1e-5 if item == 8 else 1e-12)):
                raise AssertionError(f"n={n} {m1}x{m2} rows a warp {rpw}: "
                                     f"rel_l2 {e_lib:.3e} / {e_plain:.3e}")
            times[rpw] = median_ms(call)
        emit({**base, "split": f"{m1}x{m2}", "m": m,
              "flops_a_row": dm.chirp_flops(m1, m2), "ms_by_rows_per_warp":
              times})
    del x, y
    torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(BUILD, "profile.jsonl"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_dft: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as out:
        def emit(obj) -> None:
            line = json.dumps(obj)
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()

        emit({"card": card})
        lib = build(emit)
        for n, dtype, splits in CASES:
            sweep(emit, lib, n, dtype, splits)
    return 0


if __name__ == "__main__":
    sys.exit(main())
