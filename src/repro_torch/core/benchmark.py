"""The benchmark suite loop: gearshifft's measurement core (paper §2.2,
Fig. 1), layered over the generic Runner.

Per selected tree node: context create (timed once per suite) -> the Runner
drives the paper's Table-1 sequence (allocate -> init_forward -> upload ->
execute_forward -> init_inverse -> execute_inverse -> download -> destroy)
for warmups + repetitions, each operation individually timed; a client
class with its own ``schedule`` (the kernel table's clients) runs that one
instead, on its own ``make_host_input``.  After the last run the output is
validated once: by default the round trip is compared against the input
(err = sample standard deviation of (input - roundtrip); err > eps marks
the node failed), or by the client class's own ``check`` hook.  A failed
node never aborts the suite: it is recorded and the suite continues.
"""

from __future__ import annotations

import traceback
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .client import Problem, TorchContext
from .plan import PlanCache, PlanRigor
from .results import ResultSink, Row
from .schedule import FFT_SCHEDULE, Runner
from .timer import Timer
from .tree import BenchNode
from .wisdom import Wisdom

DEFAULT_ERROR_BOUND = 1e-5
DEFAULT_WARMUPS = 2
DEFAULT_REPS = 10


class NoRunsError(RuntimeError):
    """Raised when a node produced no output to validate."""


@dataclass
class BenchmarkConfig:
    warmups: int = DEFAULT_WARMUPS
    repetitions: int = DEFAULT_REPS
    error_bound: float = DEFAULT_ERROR_BOUND
    rigor: PlanRigor = PlanRigor.ESTIMATE
    seed: int = 2017  # year of the paper


def make_input(problem: Problem, seed: int) -> np.ndarray:
    """The paper fills buffers with a see-saw function on [0, 1)."""
    n = problem.n_elems
    saw = (np.arange(n, dtype=np.float64) % 512) / 512.0
    x = saw.reshape(problem.batch, *problem.extents).astype(problem.real_dtype)
    if problem.complex_input:
        x = x.astype(problem.input_dtype)
    return x


#: Elements per chunk of :func:`roundtrip_error`'s two passes: its
#: complex128 temporaries stay in cache instead of spanning the signal.
ROUNDTRIP_CHUNK = 1 << 20


def roundtrip_error(x: np.ndarray, y: np.ndarray) -> float:
    """epsilon = sample standard deviation of (input - roundtrip) (paper
    §2.2), in complex128, over chunks: one pass for the mean, one for the
    squared deviations."""
    x, y = x.ravel(), y.ravel()
    n = x.size
    if n < 2:
        d = x.astype(np.complex128) - y.astype(np.complex128)
        return float(np.abs(d).max(initial=0.0))
    chunks = range(0, n, ROUNDTRIP_CHUNK)
    diff = lambda i: np.subtract(x[i:i + ROUNDTRIP_CHUNK],
                                 y[i:i + ROUNDTRIP_CHUNK], dtype=np.complex128)
    mean = sum(diff(i).sum() for i in chunks) / n
    ss = 0.0
    for i in chunks:
        d = diff(i)
        d -= mean
        ss += float(np.vdot(d, d).real)
    return float(np.sqrt(ss / (n - 1)))


def run_node(node: BenchNode, *, context: TorchContext,
             config: BenchmarkConfig, writer: ResultSink,
             plan_cache: Optional[PlanCache] = None,
             wisdom: Optional[Wisdom] = None, verbose: bool = False) -> None:
    """Drive one tree node through its schedule; record rows, never raise
    (a failed config is a recorded failure)."""
    p = node.problem
    cfg = config
    base = dict(library=node.client_cls.title,
                device=getattr(context, "device_kind", "?"),
                extents="x".join(map(str, p.extents)), rank=p.rank,
                extent_class=node.extent_class, precision=p.precision,
                kind=p.kind, rigor=cfg.rigor.value)
    schedule = getattr(node.client_cls, "schedule", None) or FFT_SCHEDULE
    make_host = getattr(node.client_cls, "make_host_input", None)
    host_in = (make_host(p, cfg.seed) if make_host is not None
               else make_input(p, cfg.seed))
    runner = Runner(schedule, cfg.warmups, cfg.repetitions)
    # the run's client, live when its record is emitted: every row of the
    # run learns where its plan came from
    holder: dict = {}

    def emit(rec):
        # a warmup record carries only its cold-build ops
        ops = (tuple(op for op, ev in rec.cache.items() if ev == "miss")
               if rec.warmup else schedule.op_names)
        source = getattr(holder.get("client"), "plan_source", "")
        for op in ops:
            writer.add(Row(**base, run=rec.run, op=op,
                           time_ms=rec.times[op],
                           bytes=rec.nbytes.get(op, 0),
                           plan_cache=rec.cache.get(op, ""),
                           plan_source=source))

    def make_client():
        holder["client"] = node.client_cls(p, context, rigor=cfg.rigor,
                                           wisdom=wisdom,
                                           plan_cache=plan_cache)
        return holder["client"]

    try:
        _, last_out = runner.run(make_client, host_in, on_record=emit)
        if cfg.repetitions <= 0 or last_out is None:
            raise NoRunsError(
                "no runs executed (repetitions=0 or download never ran)")
        check = getattr(node.client_cls, "check", None)
        if check is not None:
            ok, msg = check(p, host_in, last_out, cfg.error_bound)
            detail = msg or "ok"
        else:
            err = roundtrip_error(host_in, last_out.reshape(host_in.shape))
            ok = err <= cfg.error_bound
            msg = "" if ok else f"roundtrip_err={err:.3e}"
            detail = f"err={err:.2e}"
        writer.add(Row(**base, run=cfg.repetitions, op="validate",
                       time_ms=0.0, bytes=0, success=bool(ok),
                       error="" if ok else msg))
        if verbose:
            print(f"[{'ok' if ok else 'FAIL'}] {node.path} {detail}")
    except NoRunsError as e:
        writer.add(Row(**base, run=0, op="validate", time_ms=0.0,
                       bytes=0, success=False, error=str(e)))
        if verbose:
            print(f"[SKIP] {node.path}: {e}")
    except Exception as e:  # failed config: record, continue with next node
        writer.add(Row(**base, run=0, op="validate", time_ms=0.0,
                       bytes=0, success=False,
                       error=f"{type(e).__name__}: {e}"))
        if verbose:
            print(f"[FAIL] {node.path}: {e}")
            traceback.print_exc()


def run_nodes(nodes: Sequence[BenchNode], *, context: TorchContext,
              config: BenchmarkConfig, writer: ResultSink,
              plan_cache: Optional[PlanCache] = None,
              wisdom: Optional[Wisdom] = None,
              verbose: bool = False) -> ResultSink:
    """The suite loop: timed context create, every node, context destroy."""
    with Timer() as t_ctx:
        context.create()
    writer.add(Row("context", getattr(context, "device_kind", "?"),
                   "-", 0, "-", "-", "-", "-", 0, "create_context",
                   t_ctx.time_ms))
    for node in nodes:
        run_node(node, context=context, config=config, writer=writer,
                 plan_cache=plan_cache, wisdom=wisdom, verbose=verbose)
    context.destroy()
    return writer
