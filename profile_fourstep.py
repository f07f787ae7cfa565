"""Time variant builds of the four-step kernel's FFT body on one GPU.

    python3 profile_fourstep.py [--out build/fourstep_profile.jsonl]

``chip_smoke.py`` checks both bodies of the four-step kernel
(``csrc/fft4step.cu``), prints their ptxas report and times them with a
tile sweep; ``ab_kernels.py`` compares two trees.  This script measures
what neither does: copies of the kernel source under
``build/fourstep_profile/`` with one of the FFT body's design choices
changed (``VARIANTS``: complex128's loads in flight while staging; the
row pass's last stores as pairs of adjacent k1 a lane instead of one
point), built with the repository's nvcc flags.  It prints each variant's ptxas report
(registers, stack frame, spill stores of the FFT-body entries) and times
each (CUDA events, median of 30 after 3 warm calls; two rounds, the
second in reverse order) at the main path's shapes (``TIMED``) at the
default tile, through the library's entry as
``ops.fft`` calls it.  Each output is held against ``torch.fft``
(1e-3 / 1e-8 rel-L2), except the ``linear store`` probe's: it stores
row r's outputs one a lane at y[k2 n1 + r] instead of k1 =
digit_rev(r), every warp's store one contiguous run, so its output is a
permutation of the transform (each row's sorted magnitudes are held
instead), and its time bounds what any store order could gain.
Prints one JSON object a line (the card's name and power limit first)
and writes them to ``--out``.
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
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fft4step import fft4step as fs  # noqa: E402
from repro_torch.kernels.fft4step import ops  # noqa: E402

#: (label, n, rows, dtype) timed: P3, P5, P10's and P12's long side,
#: D1's sides, P11's long side (two launches), P7's axis, P1's packed
#: inner axis, P2's axis, P4's packed axis
TIMED = (("P3", 4096, 16384, torch.complex64),
         ("P5", 945, 65536, torch.complex64),
         ("P10 n2", 16384, 4096, torch.complex64),
         ("P12 n2", 16384, 8192, torch.complex64),
         ("D1 side", 8192, 8192, torch.complex64),
         ("P11 n2", 16384, 2048, torch.complex128),
         ("P7 axis", 64, 524288, torch.complex128),
         ("P1 inner", 128, 65536, torch.complex64),
         ("P2 axis", 128, 16384, torch.complex128),
         ("P4 packed", 1536, 3072, torch.complex64))
#: the row pass's last stores, one point a lane (``fft4step.cu``)
ONE_A_LANE = """#pragma unroll
      for (int k = 0; k < F; ++k) {
        const Cx<T> v = a[order.at[k]];
        o[k * os] = c.inv ? Cx<T>{v.re * c.scale, -v.im * c.scale} : v;
      }"""
#: pairs of adjacent k1 a lane: where a warp's lanes share one task's
#: rows and the n1 side's first radix f0 is even with d = n1 / f0 a power
#: of two under 32, row r ^ d holds k1 ^ 1, so the two lanes swap half
#: their outputs by shuffle and store pairs (16 bytes in complex64)
PAIRS = """const int pd = cside.len / cside.f[0];
      const bool pair = c.rows % 32 == 0 && c.valid_rows == c.rows &&
                        cside.f[0] % 2 == 0 && pd < 32 && (pd & (pd - 1)) == 0;
      auto value = [&](int k) {
        const Cx<T> v = a[order.at[k]];
        return c.inv ? Cx<T>{v.re * c.scale, -v.im * c.scale} : v;
      };
      if (pair) {
        const bool even = ((c.row0 + r) & pd) == 0;
#pragma unroll
        for (int k = 0; k + 1 < F; k += 2) {
          const Cx<T> v0 = value(k), v1 = value(k + 1);
          const Cx<T> send = even ? v1 : v0;
          const Cx<T> got{__shfl_xor_sync(0xffffffffu, send.re, pd),
                          __shfl_xor_sync(0xffffffffu, send.im, pd)};
          Cx<T>* q = even ? o + k * os : o + (k + 1) * os - 1;
          const Cx<T> lo = even ? v0 : got, hi = even ? got : v1;
          if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float4*>(q) =
                make_float4(lo.re, lo.im, hi.re, hi.im);
          } else {
            q[0] = lo;
            q[1] = hi;
          }
        }
        if (F % 2) o[(F - 1) * os] = value(F - 1);
      } else {
#pragma unroll
        for (int k = 0; k < F; ++k) o[k * os] = value(k);
      }"""
#: each variant's edits of ``fft4step.cu``: (text, replacement), the text
#: found exactly once
VARIANTS = {
    "base": (),
    "pair stores": ((ONE_A_LANE, PAIRS),),
    "linear store": (("const int k1 = digit_rev(c.row0 + r, cside, "
                      "cside.passes);", "const int k1 = c.row0 + r;"),),
    "16 loads c128": (("constexpr int kLoadsD = 8;",
                       "constexpr int kLoadsD = 16;"),),
    "4 loads c128": (("constexpr int kLoadsD = 8;",
                      "constexpr int kLoadsD = 4;"),),
}
#: variants whose output is a permutation of the transform
PERMUTED = {"linear store"}
LIBRARY_TOL = {torch.complex64: 1e-3, torch.complex128: 1e-8}


def rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


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


def build_variant(name: str, edits) -> dict:
    """A copy of the kernel source with ``edits`` made, built by nvcc: the
    library and the ptxas report of its FFT-body entries."""
    d = os.path.join(ROOT, "build", "fourstep_profile",
                     name.replace(" ", "_"))
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    path = os.path.join(d, "fft4step.cu")
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(d, "libfft4step.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    report, entry, frame = [], None, None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            frame = [int(v) for v in m.groups()]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and "fft4step_fft" in entry:
            t = re.search(r"(fft4step_fft\w*kernel)I(\w)", entry)
            report.append([{"f": "c64", "d": "c128"}[t.group(2)], t.group(1),
                           int(m.group(1)), *frame])
            entry = None
    return {"lib": ctypes.CDLL(so), "ptxas": report}


def variant_call(lib, x, y, t, tile):
    """One forward call of a variant library's FFT-body entry, as
    ``ops.fft`` makes it (a tile of None: the two launches)."""
    n1, n2 = t.n1, t.n2
    rows = x.numel() // (n1 * n2)
    item = x.element_size()
    sfx = "f64" if item == 16 else "f32"
    stream = torch.cuda.current_stream(x.device).cuda_stream
    c = ctypes
    if tile is None:
        fn = getattr(lib, f"fft4step_fft_passes_{sfx}")
        fn.argtypes = [c.c_void_p] * 4 + [c.c_longlong] + [c.c_int] * 13 \
            + [c.c_void_p]
        tc, tr = ops.pass_tiles(n1, n2, item)
        tmp = torch.empty_like(x)
        err = fn(x.data_ptr(), tmp.data_ptr(), y.data_ptr(),
                 t.roots.data_ptr(), rows, n1, n2, *ops.radix_args(n1, n2),
                 tc, tr, fs.fft_pitch(tc, n1, item),
                 fs.fft_pitch(n2, tr, item), 0, stream)
    else:
        fn = getattr(lib, f"fft4step_fft_{sfx}")
        fn.argtypes = [c.c_void_p] * 3 + [c.c_longlong] + [c.c_int] * 12 \
            + [c.c_void_p]
        err = fn(x.data_ptr(), y.data_ptr(), t.roots.data_ptr(), rows, n1,
                 n2, *ops.radix_args(n1, n2), tile,
                 fs.fft_pitch(n2, tile * n1, item),
                 fs.fft_threads(n1, n2, tile, item), 0, stream)
    if err:
        raise RuntimeError(f"cudaError_t {err}")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(ROOT, "build",
                                                 "fourstep_profile.jsonl"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_fourstep: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    out = open(args.out, "w")

    def emit(obj) -> None:
        line = json.dumps(obj)
        print(line, flush=True)
        out.write(line + "\n")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"card": smi})
    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda kv: build_variant(*kv),
                                            VARIANTS.items())))
    for name, v in built.items():
        emit({"variant": name, "ptxas": v["ptxas"]})
    gen = torch.Generator(device=dev).manual_seed(7)
    for label, n, rows, dtype in TIMED:
        n1, n2 = ops.choose_factors(n)
        item = 16 if dtype == torch.complex128 else 8
        tile = ops.default_tile_b(n1, n2, rows, item, dev) \
            if ops.one_block(n1, n2, item) else None
        x = torch.randn((rows, n), dtype=dtype, device=dev, generator=gen)
        y = torch.empty_like(x)
        t = ops.make_tables(n, False, dtype, dev)
        want = torch.fft.fft(x[:64])
        row = {"shape": label, "n": n, "rows": rows, "tile_b": tile,
               "ms": {name: [] for name in built}}
        for name, v in built.items():
            variant_call(v["lib"], x, y, t, tile)
            torch.cuda.synchronize(dev)
            if name in PERMUTED:
                e = rel_l2(y[:64].abs().sort(dim=-1).values,
                           want.abs().sort(dim=-1).values)
            else:
                e = rel_l2(y[:64], want)
            if not e <= LIBRARY_TOL[dtype]:
                raise AssertionError(f"{name} {label}: {e}")
        # two rounds, the second in reverse order
        for order in (list(built), list(built)[::-1]):
            for name in order:
                row["ms"][name].append(median_ms(
                    lambda: variant_call(built[name]["lib"], x, y, t, tile)))
        emit(row)
        del x, y
        torch.cuda.empty_cache()
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
