"""Paper Fig. 8: real against complex transforms (8a) and single against
double precision (8b), on ``TorchFFT`` (cuFFT through ``torch.fft``).
The paper's expectation: R2C about 2x faster than C2C where memory
bound; f64 about 2x slower than f32."""

from __future__ import annotations

from dataclasses import replace

from ..core.suite import Session, SuiteSpec
from .common import emit, run_suite

EXTENTS = ("4096", "65536", "32x32x32")

SPECS = (
    # 8a: real vs complex, single precision
    SuiteSpec(clients=("TorchFFT",), extents=EXTENTS,
              kinds=("Outplace_Real", "Outplace_Complex"),
              precisions=("float",),
              warmups=1, plan_cache=False, output=None),
    # 8b: single vs double, real input
    SuiteSpec(clients=("TorchFFT",), extents=EXTENTS,
              kinds=("Outplace_Real",), precisions=("float", "double"),
              warmups=1, plan_cache=False, output=None),
)


def run(reps: int = 3, session: Session | None = None) -> None:
    """Both specs through ``Session.run`` (a fresh Session on ``cuda:0``
    unless one is given); one CSV row of mean ``execute_forward`` us per
    node."""
    for spec in SPECS:
        results = run_suite(replace(spec, repetitions=reps), session)
        for a in results.aggregate_named(op="execute_forward"):
            emit(f"dtype/{a.kind}/{a.precision}/{a.extents}", a.mean * 1e3)
