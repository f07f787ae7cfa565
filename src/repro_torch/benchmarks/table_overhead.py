"""Paper Fig. 2: the framework's measurement overhead.

Compares the round trip as the framework measures it (the sum of the
per-op timers, upload through download) against one timer around a
standalone loop over the same transforms (standalone-tts) at two signal
sizes.  The paper's claim: overhead < 2%, shrinking with size.  Here
every framework op ends in a device synchronize, while the standalone
loop synchronizes once at its end.
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from ..core.benchmark import make_input
from ..core.candidates import Candidate
from ..core.client import Problem
from ..core.clients.torch_fft import _forward_fn, _inverse_fn
from ..core.suite import Session, SuiteSpec
from .common import emit, run_suite

SPEC = SuiteSpec(clients=("TorchFFT",), kinds=("Inplace_Real",),
                 precisions=("float",), warmups=2, plan_cache=False,
                 output=None)

EXTENTS = ((32, 32, 32), (64, 64, 64))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _standalone_tts(problem: Problem, reps: int,
                    device: torch.device) -> float:
    """One timer around the whole round trip (the paper's standalone-tts),
    uploading the host input every iteration; us per iteration."""
    cand = Candidate("xla")
    fwd = _forward_fn(problem, cand, device)
    inv = _inverse_fn(problem, cand, device)
    host = make_input(problem, 0)
    inv(fwd(torch.from_numpy(host).to(device)))   # warmup
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        inv(fwd(torch.from_numpy(host).to(device)))
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1e6


def run(reps: int = 5, session: Session | None = None) -> None:
    """The spec through ``Session.run`` at each extent (a fresh Session on
    ``cuda:0`` unless one is given), then the standalone loop on the
    session's device; per extent the framework's and the standalone
    round trip in us and their ratio in percent."""
    session = session if session is not None else Session()
    for ext in EXTENTS:
        name = "x".join(map(str, ext))
        results = run_suite(replace(SPEC, extents=(name,), repetitions=reps),
                            session)
        # framework view: sum of measured per-op times (upload..download)
        per_run: dict[int, float] = {}
        for op in ("upload", "execute_forward", "execute_inverse", "download"):
            for r in results.query(op=op):
                per_run[r.run] = per_run.get(r.run, 0.0) + r.time_ms
        fw_us = 1e3 * np.mean(list(per_run.values()))
        sa_us = _standalone_tts(Problem(ext, "Inplace_Real", "float"), reps,
                                session.context.device)
        emit(f"overhead/framework/{name}", fw_us, "per-op timers")
        emit(f"overhead/standalone_tts/{name}", sa_us, "single timer")
        emit(f"overhead/ratio/{name}", fw_us / sa_us * 100, "percent")
