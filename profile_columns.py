"""Sweep the Stockham column pass on one GPU: its tile and its families'
register bounds.

    python3 profile_columns.py [--out build/columns/profile.jsonl]

The column pass (``csrc/stockham_columns.cuh``, ``stockham_columns_kernel``)
bounds each case family's registers with ``column_threads`` and
``column_min_blocks``, and ``ops.column_layout`` picks its tile (columns a
block).  For each variant of the bounds below this script builds an edited
copy of the kernel sources under ``build/columns/<variant>/`` with the
repository's nvcc flags, prints ptxas's registers and spills of every
column instantiation, and times both column passes (CUDA events, median of
20 after a warm call) at B1's 65536 x 1024 and 2^20 x 64 complex64, P13's
13720 x 8192 complex128 and fft2's 256 x 256 x 1024 complex64, at the
default tile and at tiles of 4, 8 and 16 columns where one block holds
them; every output is held against ``torch.fft`` (1e-3 / 1e-8 rel-L2).
The variants run in turns, forward then backward, in one process, so
compare them within one run.  Prints one JSON object a line (the card's
name and power limit first) and writes them to ``--out`` too.
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
from repro_torch.kernels.fft2_pallas import ops as f2  # noqa: E402
from repro_torch.kernels.stockham_pallas import block  # noqa: E402
from repro_torch.kernels.stockham_pallas import ops as sp  # noqa: E402

#: name: (body of column_threads, body of column_min_blocks, the host's
#: column max_threads(family, itemsize)); "committed" is the header's own
VARIANTS = {
    "committed": (None, None, None),
    "block_fft_bounds": (
        "return family_threads(family, dbl);", "return 1;",
        lambda f, i: 512 if f == block.ONE_STAGE and i == 8 else 256),
    "c128_two_blocks": (
        "return family_threads(family, dbl);",
        "return dbl ? 2 : 1;",
        lambda f, i: 512 if f == block.ONE_STAGE and i == 8 else 256),
    "c64_pow2_three_blocks": (
        "return dbl && family != kSmallPow2 ? 64 : "
        "(!dbl && family == kSmallPow2 ? 128 : family_threads(family, dbl));",
        "return dbl && family != kSmallPow2 ? 6 : "
        "(!dbl && family == kSmallPow2 ? 3 : 1);",
        lambda f, i: 64 if i == 16 and f != block.SMALL_POW2 else
        128 if i == 8 and f == block.SMALL_POW2 else
        512 if f == block.ONE_STAGE and i == 8 else 256),
}
#: (n, rows, dtype) of the Stockham kernel's two passes; fft2's shape
SHAPES = ((65536, 1024, torch.complex64), (1 << 20, 64, torch.complex64),
          (13720, 8192, torch.complex128))
FFT2 = (256, 256, 1024)
TILES = (None, 4, 8, 16)
REPS = 20


def build(name: str, threads_body, blocks_body) -> dict:
    """The variant's libraries (``stockham``, ``stockham64``) and its
    ptxas report of the column instantiations."""
    d = os.path.join(ROOT, "build", "columns", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    path = os.path.join(d, "stockham_columns.cuh")
    with open(path) as f:
        text = f.read()
    for fn, body in (("column_threads", threads_body),
                     ("column_min_blocks", blocks_body)):
        if body is not None:
            text, n = re.subn(
                rf"(constexpr int {fn}\(int family, bool dbl\) \{{\n  )"
                r"return [^\n]*;", lambda m: m.group(1) + body, text)
            assert n == 1, fn
    with open(path, "w") as f:
        f.write(text)
    libs, report = {}, []
    for src in ("stockham", "stockham64"):
        so = os.path.join(d, f"lib{src}.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                               os.path.join(d, f"{src}.cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(proc.stderr)
        entry = frame = None
        for line in proc.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores", line)
            if m:
                frame = [int(v) for v in m.groups()]
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and entry and "stockham_columns_kernel" in entry:
                t = re.search(r"kernelI(\w)Li(\d)E", entry)
                report.append({"dtype": {"f": "complex64",
                                         "d": "complex128"}[t.group(1)],
                               "family": int(t.group(2)),
                               "registers": int(m.group(1)),
                               "stack": frame[0], "spill_stores": frame[1]})
                entry = None
        libs[src] = ctypes.CDLL(so)
    return {"libs": libs, "ptxas": report}


def use(variant: str, built: dict, tile) -> None:
    """Route ``ops.column_pass`` to the variant's kernels, its host bound
    on threads and the tile (None: ``column_layout``'s rule)."""
    libs = built[variant]["libs"]
    fns = {torch.complex64: block.column_entry(
               libs["stockham"].stockham_columns_f32),
           torch.complex128: block.column_entry(
               libs["stockham64"].stockham_columns_f64)}
    sp._columns_kernel = fns.__getitem__
    bound = VARIANTS[variant][2]
    block.max_threads = (
        (lambda f, i, column=False: bound(f, i) if column else MAX_THREADS(f, i))
        if bound else MAX_THREADS)
    sp.column_layout = COLUMN_LAYOUT if tile is None else (
        lambda st, width, item, k_fast: block.column_layout(
            st.n, tile, st.radices, st.bases, item, k_fast))
    for fn in (block.group_passes, block.column_layout, sp._column_struct):
        fn.cache_clear()


MAX_THREADS = block.max_threads
COLUMN_LAYOUT = sp.column_layout


def median_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "columns",
                                                      "profile.jsonl"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_columns: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    out = open(args.out, "w")

    def emit(obj) -> None:
        line = json.dumps(obj)
        print(line, flush=True)
        out.write(line + "\n")

    emit({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()})
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda kv: build(kv[0], *kv[1][:2]), VARIANTS.items())))
    for name in VARIANTS:
        emit({"variant": name, "ptxas": built[name]["ptxas"]})
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    cases = [("stockham", n, rows, dt) for n, rows, dt in SHAPES] + \
        [("fft2", *FFT2, torch.complex64)]
    for case in cases:
        kind, dt = case[0], case[-1]
        if kind == "stockham":
            _, n, rows, _ = case
            x = torch.randn((rows, n), dtype=dt, device=dev, generator=gen)
            plan = sp.make_twiddles(n, 8, False, dt, dev)
            call = lambda: sp.fft(x, False, twiddles=plan)
            want = torch.fft.fft(x)
        else:
            _, n1, n2, sigs, _ = case
            x = torch.randn((sigs, n1, n2), dtype=dt, device=dev,
                            generator=gen)
            plan = f2.make_twiddles2(n1, n2, 8, False, dt, dev)
            call = lambda: f2.fft2(x, False, twiddles=plan)
            want = torch.fft.fft2(x)
        row = {"shape": [kind, *case[1:-1], str(dt).removeprefix("torch.")],
               "library_ms": median_ms(lambda: (torch.fft.fft if kind ==
                                                "stockham" else
                                                torch.fft.fft2)(x))}
        tol = 1e-3 if dt == torch.complex64 else 1e-8
        for variant in order:
            for tile in TILES:
                key = f"{variant}/{tile or 'rule'}"
                use(variant, built, tile)
                try:
                    y = call()
                except ValueError as err:   # the tile does not fit a block
                    row[key] = str(err)[:60]
                    continue
                err = float((y - want).abs().norm() / want.abs().norm())
                del y
                if not err <= tol:
                    raise AssertionError(f"{key} {case}: rel_l2 {err:.3e}")
                row.setdefault(key, []).append(round(median_ms(call), 4))
        use("committed", built, None)
        emit(row)
        del x, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
