"""One run of one cell: set-up, the measured window, the check.

Set-up, in order (its time from the process's start to the first timed
pair is ``setup_s``):

1. the input, made on the device from the seed (``make_input``);
2. the cell's client (``TorchPlanned`` at ESTIMATE for the cells so far):
   ``allocate``, ``init_forward``, ``init_inverse`` (timed together, synced:
   ``init_ms``) and ``upload``;
3. warm-up pairs (the first builds or loads the kernels), then the input
   uploaded again, so that the window's first pair transforms it.

The window calls ``execute_forward`` then ``execute_inverse`` back to back
for ``seconds``: a closed loop of one caller, each call ending in the
client's own synchronize, as gearshifft times Table 1.  Checked pairs,
drawn from the seed by time (the first pair, and ``checked_pairs - 1``
more), keep a copy of their input, spectrum and round trip; the copies are
outside the pairs' times, inside the window's.  Before a checked pair after
the first, the harness rolls the batch's rows by a seeded shift, so that
the pair's input differs from the one before it: every pair's input is
otherwise the last one's round trip, and a forward that returned a stale
spectrum would pass.  With ``trace`` the window
runs under ``torch.profiler``.

After the window the peak memory is read, the client destroyed, and the
copies held to the plain reference (``check.py``).
"""

from __future__ import annotations

import contextlib
import importlib
import pkgutil
import random
import sys
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import check, loader, tracing, yardstick
from .loader import Cell

SNAPSHOT, WINDOW = tracing.SNAPSHOT, tracing.WINDOW


@dataclass
class Run:
    """What a run measured: the metric readers read this."""

    cell: Cell
    problem: yardstick.Problem
    setup_s: float
    init_ms: float
    pairs: int
    window_s: float
    pair_s: list[float]
    launches: dict[str, int]
    launch_shapes: dict[str, Counter]
    trace: tracing.Trace | None = None
    setup_phases: dict[str, float] = field(default_factory=dict)
    plan: str = ""
    memory_peak_bytes: int = 0
    errors: list[dict] = field(default_factory=list)
    check_s: float = 0.0


def input_dtype(problem: yardstick.Problem) -> torch.dtype:
    return {("float", True): torch.complex64, ("float", False): torch.float32,
            ("double", True): torch.complex128,
            ("double", False): torch.float64}[
        (problem.precision, problem.complex_input)]


def make_input(problem: yardstick.Problem, seed: int,
               device: torch.device) -> torch.Tensor:
    """The cell's input: standard normal values (each complex part of
    variance 1/2), from a generator on the device seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn((problem.batch, *problem.extents),
                       dtype=input_dtype(problem), generator=gen,
                       device=device)


def _kernel_ops() -> dict:
    """Each kernel package's ``ops`` module of the port (each counts its
    ``LAUNCHES`` and ``LAUNCH_SHAPES``), by package name."""
    import repro_torch.kernels as kernels

    return {info.name: importlib.import_module(
                f"repro_torch.kernels.{info.name}.ops")
            for info in pkgutil.iter_modules(kernels.__path__) if info.ispkg}


def _counters(mods: dict) -> tuple[dict, dict]:
    return ({k: int(m.LAUNCHES) for k, m in mods.items()},
            {k: Counter(m.LAUNCH_SHAPES) for k, m in mods.items()})


def program_client(cell: Cell, problem, device: torch.device):
    """The cell's client of the port, as the traffic names it."""
    from repro_torch.core.client import Problem, TorchContext
    from repro_torch.core.clients import torch_fft
    from repro_torch.core.plan import PlanRigor

    context = TorchContext(device)
    context.device_kind = context.discover_kind()
    cls = getattr(torch_fft, cell.traffic["client"])
    return cls(Problem(problem.extents, problem.kind, problem.precision,
                       problem.batch), context,
               rigor=PlanRigor[cell.traffic["rigor"]])


def _plan_key(client) -> str:
    plan = getattr(client, "plan", None)
    return plan.candidate.key() if plan is not None else type(client).__name__


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_process: float, device: str = "cuda",
             make_client=program_client, batch: int | None = None) -> Run:
    """One run of ``cell``; ``make_client(cell, problem, device)`` gives the
    system under test (the port's client; the control and the fault tests
    put another in its place)."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    problem = cell.problem(batch)
    phases = {}
    mark = lambda name: phases.__setitem__(name,
                                           time.perf_counter() - t_process)

    x0 = make_input(problem, seed, dev)
    host = x0.cpu().numpy()
    del x0
    mark("input")
    client = make_client(cell, problem, dev)
    client.allocate()
    t0 = time.perf_counter()
    client.init_forward()
    client.init_inverse()
    init_ms = (time.perf_counter() - t0) * 1e3
    client.upload(host)
    mark("client")
    for _ in range(int(cell.traffic["warmup_pairs"])):
        client.execute_forward()
        spec_like = client._spec
        client.execute_inverse()
    mark("warmup")
    client.upload(host)

    rng = random.Random(seed)
    at = [0.0] + sorted(rng.uniform(0.05, 0.95) * seconds
                        for _ in range(int(cell.traffic["checked_pairs"]) - 1))
    checked = [check.Checked(
        at_s=a, shift=rng.randrange(problem.batch),
        x=None if i == 0 else torch.empty_like(client._buf),
        s=torch.empty(spec_like.shape, dtype=spec_like.dtype, device=dev),
        r=torch.empty_like(client._buf)) for i, a in enumerate(at)]
    mods = _kernel_ops()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    prof = None
    span = contextlib.nullcontext
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                         else [])
        prof = profile(activities=acts)
        prof.start()
        span = record_function

    launches0, shapes0 = _counters(mods)
    pair_s: list[float] = []
    k = 0
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    deadline = t_start + seconds
    with span(WINDOW):
        while True:
            now = time.perf_counter()
            if pair_s and now >= deadline:
                break
            take = k < len(checked) and now - t_start >= checked[k].at_s
            if take and checked[k].x is not None:
                with span(SNAPSHOT):
                    # rows in another order than the pair before saw them,
                    # so that a stale spectrum shows
                    checked[k].x.copy_(torch.roll(client._buf,
                                                  checked[k].shift, 0))
                    client._buf.copy_(checked[k].x)
                    sync()
            t0 = time.perf_counter()
            with span("execute_forward"):
                client.execute_forward()
            t1 = time.perf_counter()
            if take:
                with span(SNAPSHOT):
                    checked[k].s.copy_(client._spec)
                    sync()
            t2 = time.perf_counter()
            with span("execute_inverse"):
                client.execute_inverse()
            t3 = time.perf_counter()
            if take:
                with span(SNAPSHOT):
                    checked[k].r.copy_(client._buf)
                    sync()
                checked[k].pair = len(pair_s)
                k += 1
            pair_s.append(t1 - t0 + t3 - t2)
    window_s = t3 - t_start
    launches1, shapes1 = _counters(mods)
    tr = None
    if prof is not None:
        prof.stop()
        if on_card:
            src = Path(sys.modules["repro_torch"].__file__).parent / "csrc"
            tr = tracing.from_kineto(prof.profiler.kineto_results.events(),
                                     tracing.port_kernels(src))
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    plan = _plan_key(client)
    client.destroy()
    del client, spec_like

    t0 = time.perf_counter()
    done = [c for c in checked if c.pair is not None]
    x0 = torch.from_numpy(host).to(dev)
    ref = loader.reference(cell.config["reference"])
    dft = ref.Dft(problem.extents, real=not problem.complex_input)
    errs = check.errors(dft, x0, done)
    return Run(cell=cell, problem=problem, setup_s=setup_s, init_ms=init_ms,
               pairs=len(pair_s), window_s=window_s, pair_s=pair_s,
               launches={m: launches1[m] - launches0[m] for m in mods},
               launch_shapes={m: shapes1[m] - shapes0[m] for m in mods},
               trace=tr, setup_phases=phases, plan=plan,
               memory_peak_bytes=peak, errors=errs,
               check_s=time.perf_counter() - t0)


def verdict(run: Run) -> tuple[bool, int, dict]:
    """(correct, failed checked pairs, each number compared with its
    limit).  A number over its limit, or not a number, fails."""
    limits = run.cell.spec["limits"]
    failed = sum(1 for e in run.errors
                 if not all(e[name] <= lim for name, lim in limits.items()))
    checks = {name: {"value": max((e[name] for e in run.errors),
                                  default=float("nan"), key=_nan_first),
                     "limit": lim} for name, lim in limits.items()}
    return bool(run.errors) and failed == 0, failed, checks


def _nan_first(v: float) -> float:
    return float("inf") if v != v else v


def metrics(run: Run, names) -> dict:
    """Each named metric that its reader finds, with its unit from
    ``BENCHMARK.json``."""
    bench = loader.benchmark()
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    out = {}
    for name in names:
        value = loader.reader(name)(run)
        if value is not None:
            out[name] = {"value": float(value), "unit": units[name]}
    return out


def launches_per_pair(run: Run) -> dict[str, float]:
    return {m: n / run.pairs for m, n in run.launches.items() if n}
