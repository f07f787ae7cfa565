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

With ``--serve`` the grid benches the FFT serving layer instead
(``repro_torch.serve``): a seeded Zipf mixed-shape replay per backend of
``SERVE_BACKENDS`` (p50/p95/p99 enqueue-to-complete latency, sustained
GiB/s, coalesce and plan-cache counters) and the coalesced-against-serial
same-shape burst, whose ``speedup`` is what coalescing buys; with
``--serve --chaos``, the two seeded fault-injection scenarios
(``chaos_fallback``, ``chaos_kill``), each graded by ``chaos_replay``:

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_grid --serve \
        --out serve.json
    PYTHONPATH=src python -m repro_torch.benchmarks.bench_grid --serve \
        --chaos --smoke --out chaos.json

Both write the same schema-2 document, whose rows carry the ``mode``
values ``core/compare.py``'s ``METRICS`` names.

With ``--devices 1 2 4`` the grid is the scaling mode of the
distributed decompositions: one group of N ranks per count (``nccl``, one
rank per card, on the card; ``gloo`` ranks with ``--device cpu``), each
benching ``xla`` and the decompositions (``dist1d``, ``slab``, ``pencil``
in the transposed layout, with the planner's local engines) over one
extent per paper class, merged into one document whose ``meta`` holds the
``device_counts`` and each count's worker meta.  A dist row carries
``devices``, ``mesh`` and the all_to_all traffic one forward sends from a
rank (``collective_calls``, ``collective_bytes``, counted at the call
site).  A count over the visible cards raises; it never runs on the CPU
instead:

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_grid \
        --devices 1 --smoke --out dist.json
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
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

#: One extent per paper class for the --devices scaling grid (all
#: shardable over 8 ranks): 1D/3D powerof2, 3D radix357, 1D oddshape
#: (438976 = 2^6 * 19^3 factors as 152 x 2888, both divisible by 8).
SCALING_EXTENTS = ("4096", "64x64x64", "48x48x48", "438976")
SMOKE_SCALING_EXTENTS = ("1024", "8x8x8", "12x12x12", "304")

DIST_BACKENDS = ("dist1d", "slab", "pencil")

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


def bench_dist_backend(backend: str, extents: tuple[int, ...], batch: int,
                       reps: int, warmups: int, timer: RepTimer,
                       device_kind: str) -> dict:
    """One scaling row: a decomposition over every rank of the default
    group, in the TRANSPOSED-output layout with the planner's local
    engines, timed on this rank (every rank runs it: the collectives keep
    them in step).  An unsupported or failing row is recorded."""
    from ..core.candidates import _pencil_mesh_shapes
    from ..core.clients.dist_fft import dist_engines
    from ..fft import distributed as dfft
    from ..launch.mesh import flat_mesh, reshaped_mesh

    p_dev = torch.distributed.get_world_size()
    b = 1 if backend == "dist1d" else batch  # dist1d takes the whole axis
    problem = Problem(extents, "Outplace_Complex", "float", batch=b)
    rec = {"backend": backend, "extent": "x".join(map(str, extents)),
           "rank": len(extents), "batch": b,
           "kind": problem.kind, "precision": problem.precision,
           "class": classify(extents), "devices": p_dev}
    if backend == "pencil":
        shapes = _pencil_mesh_shapes(p_dev)
        if not shapes and p_dev == 1:
            shapes = [(1, 1)]   # the degenerate one-rank point
        mesh_shape = shapes[0] if shapes else None
    else:
        mesh_shape = (p_dev,)
    rank = len(extents)
    feasible = mesh_shape is not None and (
        (backend == "dist1d" and rank == 1
         and dfft.can_shard_1d(extents[0], p_dev))
        or (backend == "slab" and rank in (2, 3)
            and dfft.slab_divisible(extents, p_dev))
        or (backend == "pencil" and rank == 3
            and dfft.pencil_divisible(extents, *mesh_shape)))
    if not feasible:
        rec.update(ok=False, error="unsupported extents/rank/device count")
        return rec
    rec["mesh"] = "x".join(map(str, mesh_shape))
    try:
        device = timer.device
        base = flat_mesh(device=device)
        cand = Candidate(backend, mesh=mesh_shape)
        engines, _ = dist_engines(problem, cand, False, device)
        x = grid_input(extents, b, device)
        if backend == "dist1d":
            mesh = reshaped_mesh(base, mesh_shape, names=("data",))
            fn, _ = dfft.make_fft1d(mesh, "data", extents[0],
                                    engines=engines, device=device)
            x, in_spec = x.reshape(-1), ("data",)
        else:
            mesh = reshaped_mesh(base, mesh_shape)
            make = (dfft.make_slab_fftnd if backend == "slab"
                    else dfft.make_pencil_fftnd)
            axes = ("d0",) if backend == "slab" else ("d0", "d1")
            fn, in_spec, _ = make(mesh, *axes, extents, engines=engines)
        xb = dfft.shard(x, mesh, in_spec).contiguous()
        calls, sent = dfft.A2A_CALLS, dfft.A2A_BYTES
        t0 = time.perf_counter()
        fn(xb)
        timer.sync()
        rec["compile_ms"] = (time.perf_counter() - t0) * 1e3
        rec["collective_calls"] = dfft.A2A_CALLS - calls
        rec["collective_bytes"] = dfft.A2A_BYTES - sent
        for _ in range(warmups):
            fn(xb)
        timer.sync()
        best = _record_times(rec, [timer(fn, xb) for _ in range(reps)])
        moved = 2 * x.numel() * x.element_size()   # one read + one write
        rec["gib_per_s"] = moved / best / 2**30
        _annotate_roofline(rec, problem, cand, best, device_kind)
        rec["ok"] = True
    except Exception as e:
        rec.update(ok=False, error=f"{type(e).__name__}: {e}")
    return rec


def _scaling_rank(args) -> int:
    """One rank of a --devices group (the hidden ``--_rank`` form): join
    the group, run the scaling grid (``xla`` and the decompositions), and
    on rank 0 write the document."""
    import torch.distributed as dist

    rank, world = args._rank, args._world
    gpu = torch.device(args.device).type == "cuda"
    device = torch.device("cuda", rank) if gpu else torch.device("cpu")
    if not gpu:
        torch.set_num_threads(1)
    kw = {"device_id": device} if gpu else {}
    dist.init_process_group("nccl" if gpu else "gloo",
                            store=dist.FileStore(args._store, world),
                            rank=rank, world_size=world, **kw)
    try:
        context = TorchContext(device)
        context.create()         # raises without the device; builds kernels
        timer = RepTimer(device)
        meta = dict(_grid_meta(context, args.batch, args.reps),
                    devices=world, backend=dist.get_backend())
        doc = {"meta": make_meta(**meta), "results": []}
        for ext in [parse_extents(str(e)) for e in args.extents]:
            x = grid_input(ext, args.batch, device)
            for backend in args.backends:
                if backend in DIST_BACKENDS:
                    rec = bench_dist_backend(backend, ext, args.batch,
                                             args.reps, args.warmups, timer,
                                             context.device_kind)
                else:
                    rec = bench_backend(backend, ext, x, args.reps,
                                        args.warmups, timer,
                                        context.device_kind)
                    rec["devices"] = world
                doc["results"].append(rec)
                if rank == 0:
                    print(f"{rec['extent']:>12s} {backend:16s} "
                          f"{_status(rec)}", flush=True)
            del x
        if rank == 0:
            with open(args.out, "w") as f:
                json.dump(doc, f, indent=1)
                f.write("\n")
    finally:
        dist.destroy_process_group()
    return 0


def _run_group(argv: list[str], world: int) -> None:
    """Start ``world`` ranks of this module (``--_rank``) and wait for all;
    when one fails, stop the others (they would wait in a collective) and
    raise with every rank's exit code."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, *argv,
                               "--_rank", str(r), "--_world", str(world)],
                              env=env) for r in range(world)]
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"--devices {world}: ranks exited with {codes}")


def _fan_out_devices(args, device_counts: list[int]) -> int:
    """The scaling grid: one group of N ranks per count, merged into one
    document.  A count over the visible cards raises."""
    if torch.device(args.device).type == "cuda":
        visible = torch.cuda.device_count()
        for n in device_counts:
            if n > visible:
                raise ValueError(f"--devices {n} needs {n} cards, one rank "
                                 f"each; {visible} visible")
    if args.smoke:
        extents, reps, warmups = (args.extents or SMOKE_SCALING_EXTENTS,
                                  1, 0)
    else:
        extents = args.extents or SCALING_EXTENTS
        reps, warmups = args.reps, args.warmups
    backends = args.backends or ("xla", *DIST_BACKENDS)
    merged = {"meta": None, "results": []}
    for n in device_counts:
        print(f"--- devices={n} ---", flush=True)
        tmp = tempfile.mkdtemp(prefix=f"bench_grid_dev{n}_")
        try:
            out = os.path.join(tmp, "doc.json")
            _run_group(["--device", args.device, "--batch", str(args.batch),
                        "--reps", str(reps), "--warmups", str(warmups),
                        "--extents", *map(str, extents),
                        "--backends", *backends, "--out", out,
                        "--_store", os.path.join(tmp, "store")], n)
            with open(out) as f:
                doc = json.load(f)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if merged["meta"] is None:
            merged["meta"] = dict(doc["meta"])
            merged["meta"]["device_counts"] = []
            merged["meta"]["workers"] = []
        merged["meta"]["device_counts"].append(n)
        merged["meta"]["workers"].append({"devices": n, **doc["meta"]})
        merged["results"].extend(doc["results"])
    with open(args.out, "w") as f:
        json.dump(merged, f, indent=1)
        f.write("\n")
    _maybe_report(args)
    print(f"wrote {len(merged['results'])} records "
          f"({len(device_counts)}-point device axis) to {args.out}")
    return 0


#: Backends the serving replay is pinned to, plus the planner (backend
#: None: per-request plan selection through the shared cache).
SERVE_BACKENDS = (None, "xla", "stockham_pallas")


def _service(config, device):
    from ..core.suite import Session
    from ..serve import FFTService
    return FFTService(Session(TorchContext(device)), config=config)


def bench_serve_replay(backend, requests: int, smoke: bool,
                       device="cuda:0") -> dict:
    """One seeded Zipf mixed-shape replay against a fresh service pinned to
    ``backend`` (None = planner-selected); records tail latency, sustained
    GiB/s, and the coalescing/cache counters."""
    from ..serve import ServeConfig, TrafficSpec, replay

    spec = TrafficSpec(
        extents=(("256", "1024", "16x16") if smoke
                 else ("1024", "4096", "256", "64x64")),
        kinds=("Outplace_Complex",) if smoke
        else ("Outplace_Complex", "Outplace_Real"),
        precisions=("float",), requests=requests, rate_hz=0.0,
        zipf_s=1.1, seed=2017)
    rec = {"mode": "serve_replay", "backend": backend or "planned",
           "traffic": spec.to_dict()}
    try:
        cfg = ServeConfig(coalesce_window_ms=2.0, max_batch=16,
                          backend=backend)
        with _service(cfg, device) as svc:
            for ext, kind, prec in spec.mix():   # steady state, not builds
                svc.prewarm(ext, kind, prec)
            rep = replay(svc, spec)
        s = rep.service
        lat = s.get("latency_ms", {})
        rec.update(ok=True, requests=s["requests"], completed=s["completed"],
                   errors=s["errors"], timeouts=s["timeouts"],
                   batches=s["batches"],
                   batched_requests=s["batched_requests"],
                   coalesce_rate=s["coalesce_rate"], rps=s["rps"],
                   gib_per_s=s["gib_per_s"], wall_s=rep.wall_s,
                   mean_ms=lat.get("mean"), p50_ms=lat.get("p50"),
                   p95_ms=lat.get("p95"), p99_ms=lat.get("p99"),
                   plan_cache=s.get("plan_cache"))
    except Exception as e:
        rec.update(ok=False, error=f"{type(e).__name__}: {e}")
    return rec


def bench_serve_burst(n_requests: int, ext: int = 4096, device="cuda:0",
                      backend: str = "xla", rows: int = 1,
                      per_batch: int = 32) -> dict:
    """Coalesced against serial-FIFO throughput on a same-shape
    closed-loop burst of ``n_requests`` requests of ``rows`` rows each.
    Serial is one request per launch, one launch at a time (window 0,
    inflight 1); coalesced stacks up to ``per_batch`` requests per launch.
    Both sides use the batch intake (``submit_many``) and a prewarmed
    bucket ladder, so the ratio isolates dispatch coalescing."""
    from ..serve import ServeConfig

    x = ((np.arange(rows * ext) % 512) / 512.0).astype(
        np.complex64).reshape((rows, ext) if rows > 1 else (ext,))

    def run(cfg):
        with _service(cfg, device) as svc:
            svc.prewarm((ext,))                 # builds outside the timing
            t0 = time.perf_counter()
            reqs = svc.submit_many([x] * n_requests, rank=1)
            for r in reqs:
                r.result(timeout=600)
            wall = time.perf_counter() - t0
        return n_requests / wall, svc.report()["batches"]

    rec = {"mode": "serve_burst", "extent": str(ext), "requests": n_requests}
    if backend != "xla" or rows != 1:
        rec.update(backend=backend, rows=rows)
    try:
        serial_rps, _ = run(ServeConfig(coalesce_window_ms=0.0,
                                        max_batch=rows, inflight=1,
                                        backend=backend))
        coalesced_rps, batches = run(ServeConfig(
            coalesce_window_ms=5.0, max_batch=per_batch * rows,
            backend=backend))
        rec.update(ok=True, serial_rps=serial_rps,
                   coalesced_rps=coalesced_rps, coalesced_batches=batches,
                   speedup=coalesced_rps / serial_rps)
    except Exception as e:
        rec.update(ok=False, error=f"{type(e).__name__}: {e}")
    return rec


def bench_chaos_fallback(requests: int, device="cuda:0") -> dict:
    """Chaos scenario 1: the top-ranked backend for the hot shape fails at
    every build (an injected compile error), plus one transient execute
    fault.  Serial FIFO (window 0, max_batch 1) keeps the recovery path
    deterministic: every request must still be delivered, through the
    fallback chain or a backoff retry, with the demotion recorded."""
    from ..core.plan import fallback_chain
    from ..serve import ServeConfig, TrafficSpec, chaos_replay

    hot = Problem((256,), "Outplace_Complex", "float")
    top = fallback_chain(hot)[0].backend
    spec = TrafficSpec(extents=("256", "64"), kinds=("Outplace_Complex",),
                       precisions=("float",), requests=requests, rate_hz=0.0,
                       zipf_s=1.1, seed=2017,
                       faults=({"fault": "compile_error", "backend": top},
                               {"fault": "execute_error", "times": 1}))
    rec = {"mode": "chaos_fallback", "top_backend": top,
           "traffic": spec.to_dict()}
    try:
        cfg = ServeConfig(coalesce_window_ms=0.0, max_batch=1,
                          breaker_threshold=1, max_retries=2)
        with _service(cfg, device) as svc:
            rep = chaos_replay(svc, spec)
        s = rep.replay.service
        rec.update(ok=rep.ok and s["demotions"] >= 1
                   and s["retry_successes"] >= 1,
                   clean_success_rate=rep.clean_success_rate,
                   poisoned=rep.poisoned, violations=rep.violations,
                   demotions=s["demotions"], retries=s["retries"],
                   retry_successes=s["retry_successes"],
                   faults_injected=s["faults_injected"],
                   quarantined=[k for k, v in s["quarantine"].items()
                                if v["state"] != "closed"],
                   wedged=s["wedged"], completed=s["completed"])
    except Exception as e:
        rec.update(ok=False, error=f"{type(e).__name__}: {e}")
    return rec


def bench_chaos_kill(requests: int, device="cuda:0") -> dict:
    """Chaos scenario 2: a worker thread is killed mid-dispatch.  The
    watchdog must fail the in-flight requests cleanly, restart the worker
    (with a new stream and new buffers), and the service must finish the
    rest of the tape: no wedge, at most the orphaned requests lost."""
    from ..serve import ServeConfig, TrafficSpec, chaos_replay

    spec = TrafficSpec(extents=("256",), kinds=("Outplace_Complex",),
                       precisions=("float",), requests=requests, rate_hz=0.0,
                       seed=2017,
                       faults=({"fault": "kill_worker", "after": 2,
                                "times": 1},))
    rec = {"mode": "chaos_kill", "traffic": spec.to_dict()}
    try:
        cfg = ServeConfig(coalesce_window_ms=0.0, max_batch=1,
                          watchdog_interval_s=0.05)
        with _service(cfg, device) as svc:
            # the dying worker can hold its current batch plus up to
            # `inflight` pending batches, so the gate tolerates that loss
            lost = 1 + cfg.inflight
            rep = chaos_replay(svc, spec,
                               min_clean_success=1.0 - (lost + 1) / requests)
        s = rep.replay.service
        rec.update(ok=rep.ok and s["worker_restarts"] >= 1
                   and s["wedged"] == 0,
                   clean_success_rate=rep.clean_success_rate,
                   violations=rep.violations, completed=s["completed"],
                   failed_in_flight=s["errors"],
                   worker_restarts=s["worker_restarts"], wedged=s["wedged"],
                   worker_errors=s["worker_errors"],
                   faults_injected=s["faults_injected"])
    except Exception as e:
        rec.update(ok=False, error=f"{type(e).__name__}: {e}")
    return rec


def _serve_meta(context: TorchContext, note: str) -> dict:
    gpu = context.device.type == "cuda"
    meta = dict(device_kind=context.device_kind,
                platform="gpu" if gpu else "cpu",
                devices=torch.cuda.device_count() if gpu else 1,
                interpret_kernels=not gpu, python=platform.python_version(),
                torch=torch.__version__, note=note)
    if gpu:
        meta["power_limit"] = power_limit()
    return make_meta(**meta)


def _write(doc: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {len(doc['results'])} records to {path}")


def _run_chaos(args, context: TorchContext) -> int:
    """The --serve --chaos grid: seeded fault-injection replays of the
    recovery machinery; exit 1 unless both scenarios are ok."""
    requests = 16 if args.smoke else 48
    doc = {"meta": _serve_meta(
        context, "chaos replay: seeded FaultPlan against the Zipf tape; "
                 "clean_success_rate counts non-poisoned requests only"),
        "results": []}
    ok = True
    for rec in (bench_chaos_fallback(requests, args.device),
                bench_chaos_kill(max(8, requests // 2), args.device)):
        doc["results"].append(rec)
        ok = ok and rec["ok"]
        status = ("clean_success={:.3f} violations={}".format(
                      rec["clean_success_rate"], rec["violations"])
                  if "clean_success_rate" in rec
                  else f"failed: {rec.get('error')}")
        print(f"{rec['mode']:16s} ok={rec['ok']} {status}")
    _write(doc, args.out)
    return 0 if ok else 1


def _run_serve(args, context: TorchContext) -> int:
    """The --serve grid: per-backend Zipf replays and the burst speedup."""
    requests = 24 if args.smoke else 96
    # a multiple of max_batch=32 (partly filled batches linger for the
    # whole coalesce window), and large enough that per-burst fixed costs
    # do not swamp the per-launch overhead the coalescer amortizes
    burst = 128
    doc = {"meta": _serve_meta(
        context, "FFT serving layer: seeded Zipf mixed-shape replay per "
                 "backend (p50/p95/p99 enqueue-to-complete) + coalesced "
                 "vs serial same-shape burst"),
        "results": []}
    for backend in SERVE_BACKENDS:
        rec = bench_serve_replay(backend, requests, args.smoke, args.device)
        doc["results"].append(rec)
        status = (f"p50={rec['p50_ms']:8.1f} ms  p99={rec['p99_ms']:8.1f} ms "
                  f"{rec['rps']:6.1f} rps  coalesce={rec['coalesce_rate']:.2f}"
                  if rec["ok"] else f"failed: {rec['error']}")
        print(f"serve_replay {rec['backend']:16s} {status}")
    rec = bench_serve_burst(burst, device=args.device)
    doc["results"].append(rec)
    if rec["ok"]:
        print(f"serve_burst  {'coalesced/serial':16s} "
              f"{rec['serial_rps']:6.1f} -> {rec['coalesced_rps']:6.1f} rps "
              f"({rec['speedup']:.1f}x)")
    else:
        print(f"serve_burst  failed: {rec['error']}")
    _write(doc, args.out)
    return 0


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
    p.add_argument("--devices", nargs="+", type=int, default=None,
                   help="device-count scaling axis, e.g. --devices 1 2 4 "
                        "(one group of ranks per count; benches xla and "
                        "the distributed decompositions)")
    p.add_argument("--serve", action="store_true",
                   help="bench the FFT serving layer (per-backend Zipf "
                        "replays + the coalesced/serial burst) instead of "
                        "the transform grid")
    p.add_argument("--chaos", action="store_true",
                   help="with --serve: the seeded fault-injection replays "
                        "(exit 1 unless both scenarios recover)")
    p.add_argument("--_rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--_world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--_store", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args._rank is not None:
        from ..launch.mesh import exit_rank
        exit_rank(_scaling_rank(args))
    if args.chaos and not args.serve:
        p.error("--chaos needs --serve")
    if args.serve:
        context = TorchContext(args.device)
        context.create()         # raises without the device; builds kernels
        return (_run_chaos if args.chaos else _run_serve)(args, context)
    if args.devices:
        return _fan_out_devices(args, args.devices)

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
    timer = RepTimer(device)
    doc = {"meta": make_meta(**_grid_meta(context, args.batch, reps)),
           "results": []}
    for ext in grid:
        x = grid_input(ext, args.batch, device)
        for backend in backends:
            rec = bench_backend(backend, ext, x, reps, warmups, timer, kind)
            rec["devices"] = 1
            doc["results"].append(rec)
            print(f"{rec['extent']:>12s} {backend:16s} {_status(rec)}")
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
    _maybe_report(args)
    print(f"wrote {len(doc['results'])} records to {args.out}")
    return 0


def _grid_meta(context: TorchContext, batch: int, reps: int) -> dict:
    gpu = context.device.type == "cuda"
    meta = dict(
        device_kind=context.device_kind, platform="gpu" if gpu else "cpu",
        devices=torch.cuda.device_count() if gpu else 1,
        interpret_kernels=not gpu, python=platform.python_version(),
        torch=torch.__version__, batch=batch, reps=reps,
        note="forward c64 transform, min-of-reps (mean/sd/n per row); "
             "CUDA events after an L2 flush on the card; gib_per_s "
             "assumes the one-read+one-write algorithmic minimum; "
             "roofline_frac is the achieved fraction of the modeled device "
             "roofline (5*N*log2(N) flops, planner bytes-moved model)")
    if gpu:
        meta["power_limit"] = power_limit()
    return meta


def _status(rec: dict) -> str:
    return (f"{rec['time_ms']:9.3f} ms  {rec['gib_per_s']:7.2f} GiB/s"
            if rec["ok"] else f"infeasible: {rec['error']}")


def _maybe_report(args) -> None:
    """The gearshifft Fig. 7 table of the document just written."""
    if args.report:
        with open(args.report, "w") as f:
            f.write(fig7_report(load_bench(args.out)))
        print(f"wrote Fig. 7 report to {args.report}")


if __name__ == "__main__":
    raise SystemExit(main())
