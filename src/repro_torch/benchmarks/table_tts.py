"""Paper Fig. 3: time-to-solution of powerof2 3-D single-precision R2C
out-of-place forward transforms, per backend: cuFFT (``TorchFFT``)
against the plain-torch Stockham and four-step baselines."""

from __future__ import annotations

from dataclasses import replace

from ..core.suite import Session, SuiteSpec, SweepSpec
from .common import emit, run_suite

BASE = SuiteSpec(clients=("TorchFFT", "TorchStockham", "TorchFourStep"),
                 kinds=("Outplace_Real",), precisions=("float",),
                 warmups=1, plan_cache=False, output=None)


def spec(max_exp: int = 5, reps: int = 3) -> SuiteSpec:
    """The table's spec: ``BASE`` over the powerof2 rank-3 sweep 8^3 ...
    (2^max_exp)^3."""
    return replace(BASE, repetitions=reps,
                   sweeps=(SweepSpec("powerof2", rank=3,
                                     min_exp=3, max_exp=max_exp),))


def run(max_exp: int = 5, reps: int = 3,
        session: Session | None = None) -> None:
    """The spec through ``Session.run`` (a fresh Session on ``cuda:0``
    unless one is given); per node one ``tts/`` row (mean ``total``, the
    whole Table-1 round trip) and one ``fft_only/`` row (mean
    ``execute_forward``), in us."""
    results = run_suite(spec(max_exp, reps), session)
    for a in results.aggregate_named(op="total"):
        emit(f"tts/{a.library}/{a.extents}", a.mean * 1e3,
             f"sd={a.sd*1e3:.1f}us n={a.n}")
    for a in results.aggregate_named(op="execute_forward"):
        emit(f"fft_only/{a.library}/{a.extents}", a.mean * 1e3,
             f"sd={a.sd*1e3:.1f}us")
