#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel from ``src/repro_torch/csrc`` (``nvcc``, into
   ``build/kernels/``);
3. holds each kernel against its plain PyTorch version on the card, and
   against ``torch.fft``, over lengths, radices, dtypes, directions and a
   ragged batch;
4. drives the port's main path at full size: ``Session.run`` over the
   ``TorchFFT`` and ``TorchStockhamPallas`` clients on five problems (the
   paper's 256^3 single-precision R2C among them), every node round-trip
   validated, and shows through the launch counts that the kernel ran;
5. holds the kernel against its plain version at every shape the main
   path launched it with (its own radix and tile, both directions), then
   times it there beside its plain version, ``torch.fft.fft`` and its
   device-memory bound;
6. prints the kernel summary and, as the last line,
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

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM data sheet: HBM3 rate, and the vector (non tensor core) peaks.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"complex64": 67e12, "complex128": 34e12}

CHECK_NS = (2, 3, 8, 12, 100, 945, 1024, 3072, 4096)
CHECK_RADICES = (2, 4, 8)
CHECK_BATCHES = (1, 37)
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
)
CLIENTS = ("TorchFFT", "TorchStockhamPallas")


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


def build() -> float:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    for name in _build.sources():
        _build.library(name)
    seconds = time.perf_counter() - t0
    for name in _build.sources():
        print(_build.build_log(name), file=sys.stderr)
    return seconds


def check_kernels(device) -> dict:
    """Kernel vs plain (on the card) and vs torch.fft; raises on a miss."""
    import torch
    from repro_torch.kernels.stockham_pallas import ops, ref

    gen = torch.Generator(device=device).manual_seed(2017)
    worst = {}
    for dtype in (torch.complex64, torch.complex128):
        name = str(dtype).removeprefix("torch.")
        w = {"dtype": name, "cases": 0, "rel_l2_plain": 0.0,
             "rel_l2_library": 0.0, "max_abs_err": 0.0,
             "max_n": ops.MAX_N[dtype]}
        for n in CHECK_NS + (ops.MAX_N[dtype],):
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
                        plain = ref.stockham_ref(x, radix, inverse)
                        lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
                        e_plain, e_lib = rel_l2(y, plain), rel_l2(y, lib)
                        if not (e_plain <= PLAIN_TOL[name]
                                and e_lib <= LIBRARY_TOL[name]):
                            raise AssertionError(
                                f"stockham kernel disagrees: n={n} radix={radix} "
                                f"batch={batch} {name} inverse={inverse}: "
                                f"rel_l2 vs plain {e_plain:.3e}, "
                                f"vs torch.fft {e_lib:.3e}")
                        w["cases"] += 1
                        w["rel_l2_plain"] = max(w["rel_l2_plain"], e_plain)
                        w["rel_l2_library"] = max(w["rel_l2_library"], e_lib)
                        w["max_abs_err"] = max(w["max_abs_err"], float(
                            (y - plain).abs().max()))
        emit({"check": "kernel_vs_plain", **w})
        worst[name] = w
    return worst


def run_main_path(device) -> dict:
    """Session.run over both clients on P1-P5; returns per-node summaries
    and the launch counts of the kernel during the run."""
    from repro_torch.core.client import TorchContext
    from repro_torch.core.clients import torch_fft
    from repro_torch.core.suite import Session, SuiteSpec
    from repro_torch.core.tree import build_tree
    from repro_torch.kernels.stockham_pallas import ops

    session = Session(TorchContext(device))
    summary = {"nodes": [], "launches": {}}
    ops.LAUNCHES = 0
    ops.LAUNCH_SHAPES.clear()
    for client in CLIENTS:
        before = ops.LAUNCHES
        for pname, extents, kind, precision, batch in PROBLEMS:
            spec = SuiteSpec(clients=(client,), extents=(extents,),
                             kinds=(kind,), precisions=(precision,),
                             batch=batch, warmups=1, repetitions=3,
                             plan_cache=True, output=None)
            nodes = build_tree([getattr(torch_fft, client)], [extents],
                               kinds=(kind,), precisions=(precision,),
                               batch=batch)
            n0 = ops.LAUNCHES
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
            node = {"node": pname, "client": client,
                    "path": nodes[0].path, "device": val[0].device,
                    "execute_forward_ms": med("execute_forward"),
                    "execute_inverse_ms": med("execute_inverse"),
                    "init_forward_ms": med("init_forward"),
                    "init_forward_cold_ms": cold[0] if cold else None,
                    "kernel_launches_per_transform":
                        (ops.LAUNCHES - n0) / transforms}
            emit(node)
            summary["nodes"].append(node)
        summary["launches"][client] = ops.LAUNCHES - before
    summary["shapes"] = dict(ops.LAUNCH_SHAPES)
    summary["total"] = ops.LAUNCHES
    emit({"main_path_launches": summary["launches"]})
    if summary["launches"]["TorchFFT"] != 0:
        raise AssertionError("the torch.fft client launched the Stockham kernel")
    if summary["launches"]["TorchStockhamPallas"] <= 0:
        raise AssertionError("TorchStockhamPallas never launched the kernel")
    return summary


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


def check_main_path_shapes(device, shapes: dict) -> dict:
    """At every (n, rows, dtype) the main path launched, the kernel with the
    main path's own knobs (radix 8, default tile) against the plain oracle
    in both directions; raises above ``PLAIN_TOL``.  Returns the worst
    rel-L2 and absolute error per shape."""
    import torch
    from repro_torch.kernels.stockham_pallas import ops, ref

    gen = torch.Generator(device=device).manual_seed(5)
    errors = {}
    for n, rows, dname in sorted(shapes):
        dtype = getattr(torch, dname)
        x = torch.randn((rows, n), dtype=dtype, device=device, generator=gen)
        rel = err = 0.0
        for inverse in (False, True):
            y = ops.fft(x, inverse)
            want = ref.stockham_ref(x, 8, inverse)
            e = rel_l2(y, want)
            if not e <= PLAIN_TOL[dname]:
                raise AssertionError(
                    f"stockham kernel disagrees at a main-path shape: n={n} "
                    f"rows={rows} {dname} inverse={inverse} tile_b="
                    f"{ops.default_tile_b(n, rows, x.element_size(), 2)}: "
                    f"rel_l2 vs plain {e:.3e}")
            rel = max(rel, e)
            err = max(err, float((y - want).abs().max()))
            del y, want
        errors[(n, rows, dname)] = {"rel_l2_plain": rel, "max_abs_err": err}
        emit({"check": "main_path_shape", "n": n, "rows": rows,
              "dtype": dname, **errors[(n, rows, dname)]})
    return errors


def time_kernels(device, shapes: dict, errors: dict) -> list[dict]:
    """Kernel, plain and torch.fft times at every main-path shape."""
    import torch
    from repro_torch.kernels.stockham_pallas import ops, ref

    gen = torch.Generator(device=device).manual_seed(7)
    rows_out = []
    for (n, rows, dname), launches in sorted(shapes.items()):
        dtype = getattr(torch, dname)
        x = torch.randn((rows, n), dtype=dtype, device=device, generator=gen)
        tw = ops.make_twiddles(n, 8, False, dtype, device)
        kernel = lambda: ops.fft(x, twiddles=tw)
        plain = lambda: ref.apply_stages(x, tw.tw, tw.radices, tw.bases, False)
        nbytes = 2 * rows * n * x.element_size()
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 5 * n * math.log2(n) * rows / PEAK_FLOPS[dname] * 1e3
        row = {"n": n, "rows": rows, "dtype": dname, "launches": launches,
               "ms": _events_ms(kernel, 20),
               "plain_ms": _events_ms(plain, 5),
               "library_ms": _events_ms(lambda: torch.fft.fft(x), 20),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               **errors[(n, rows, dname)]}
        emit({"timing": row})
        rows_out.append(row)
    return rows_out


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
    device = torch.device("cuda", 0)

    emit(card_info())
    emit({"build_s": build()})
    emit({"kernels": ["stockham_pallas"]})
    checks = check_kernels(device)
    main_path = run_main_path(device)
    errors = check_main_path_shapes(device, main_path["shapes"])
    timings = time_kernels(device, main_path["shapes"], errors)

    # the headline shape: the one that moved the most bytes on the main path
    head = max(timings, key=lambda t: t["launches"] * t["rows"] * t["n"]
               * (16 if t["dtype"] == "complex128" else 8))
    emit({"kernels": [{
        "name": "stockham_pallas", "route": "cuda",
        "source": "src/repro_torch/csrc/stockham.cu",
        "replaces": "src/repro/kernels/stockham_pallas/stockham_pallas.py:177",
        "launches": main_path["launches"]["TorchStockhamPallas"],
        "max_abs_err": max(head["max_abs_err"],
                           *(c["max_abs_err"] for c in checks.values())),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": {"n": head["n"], "rows": head["rows"], "dtype": head["dtype"]},
    }]})
    emit(card_info())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
