"""Paper Fig. 7: powerof2 against radix357 against oddshape extent
classes.  powerof2 should win; chirp-Z covers oddshape everywhere (the
cuFFT analogue), and the planner (``TorchPlanned``) picks the best
feasible backend per class."""

from __future__ import annotations

from dataclasses import replace

from ..core.extents import classify
from ..core.suite import Session, SuiteSpec
from .common import emit, run_suite

SPEC = SuiteSpec(clients=("TorchFFT", "TorchPlanned", "TorchChirpZPallas"),
                 extents=("1024", "960", str(19 * 19),        # 1D per class
                          "16x16x16", "12x12x12", "19x19x19"),
                 kinds=("Outplace_Real",), precisions=("float",),
                 warmups=1, plan_cache=False, output=None)


def run(reps: int = 3, session: Session | None = None) -> None:
    """The spec through ``Session.run`` (a fresh Session on ``cuda:0``
    unless one is given); one CSV row of mean ``execute_forward`` us per
    node, named by its extent class."""
    results = run_suite(replace(SPEC, repetitions=reps), session)
    for a in results.aggregate_named(op="execute_forward"):
        cls = classify(tuple(int(v) for v in a.extents.split("x")))
        emit(f"radix/{cls}/{a.library}/{a.extents}", a.mean * 1e3)
