"""Timer harness.

The paper measures every client operation with its own timer object (CUDA
events for cuFFT).  Here a host monotonic timer surrounds each operation,
and every device operation ends in ``torch.cuda.synchronize`` (the clients
do it; :func:`timed` does it for arbitrary functions), so the host clock
spans the device work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Timer:
    """Start/stop timer accumulating one measurement in milliseconds."""

    time_ms: float = float("nan")
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        self.time_ms = (time.perf_counter() - self._t0) * 1e3
        return self.time_ms

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def timed(fn, *args, **kwargs):
    """Run fn, waiting for the device on CUDA tensor outputs; return
    (result, milliseconds)."""
    t = Timer().start()
    out = fn(*args, **kwargs)
    _block(out)
    return out, t.stop()


def _block(out) -> None:
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
