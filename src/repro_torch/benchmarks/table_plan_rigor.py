"""Paper Figs. 4-5: plan-rigor trade-offs, planning time against
transform time for ESTIMATE (the hand-written cost model, and a fitted
one where its table exists), MEASURE and WISDOM_ONLY (wisdom
pre-generated like fftwf-wisdom, by the planner's ``near=False`` sweep),
on ``TorchPlanned``."""

from __future__ import annotations

import os
import tempfile
from dataclasses import replace

from ..core.client import Problem
from ..core.clients.torch_fft import _forward_fn
from ..core.extents import parse_extents
from ..core.plan import PlanRigor, make_plan
from ..core.suite import Session, SuiteSpec
from ..core.wisdom import Wisdom
from .common import emit, run_suite

EXTENTS = ("256", "2048", "16x16x16", "32x32x32")

#: The fitted H100 coefficient table.  Where it exists the table gains an
#: ``estimate_fitted`` column: the same instant ESTIMATE heuristic, ranked
#: by coefficients regressed on the card instead of the hand-written ones.
FITTED_TABLE = os.path.join(os.path.dirname(__file__), "baselines",
                            "costmodel_h100.json")

# plan_cache=False: every repetition re-plans, the honest Figs. 4-5 cost
SPEC = SuiteSpec(clients=("TorchPlanned",), extents=EXTENTS,
                 kinds=("Inplace_Real",), precisions=("float",),
                 warmups=1, plan_cache=False, output=None)


def _pregenerate(exts, path: str, session: Session) -> None:
    """MEASURE-sweep every extent on the session's device into a wisdom
    pack keyed by its device kind (``near=False``: a pregeneration run must
    not inherit a neighbor's pick)."""
    device = session.context.device
    wisdom = Wisdom(path, device_kind=session.device_kind)
    for ext in exts:
        problem = Problem(tuple(ext), "Inplace_Real", "float")
        make_plan(problem, PlanRigor.MEASURE,
                  build=lambda c, p=problem: _forward_fn(p, c, device),
                  wisdom=wisdom, device=device, near=False)
    wisdom.save()


def _emit_rigor(label: str, results) -> None:
    for a in results.aggregate_named(op="init_forward"):
        emit(f"plan_time/{label}/{a.extents}", a.mean * 1e3)
    for a in results.aggregate_named(op="execute_forward"):
        emit(f"fft_time/{label}/{a.extents}", a.mean * 1e3)


def run(reps: int = 3, session: Session | None = None) -> None:
    """Pregenerate wisdom into a temporary file, then the spec under
    ESTIMATE, MEASURE (no wisdom attached) and WISDOM_ONLY (that file)
    through ``Session.run`` (a fresh Session on ``cuda:0`` unless one is
    given); per rigor and extent the mean ``init_forward`` and
    ``execute_forward`` in us."""
    session = session if session is not None else Session()
    exts = [parse_extents(e) for e in EXTENTS]
    with tempfile.TemporaryDirectory() as td:
        wpath = os.path.join(td, "wisdom.json")
        _pregenerate(exts, wpath, session)
        for rigor in (PlanRigor.ESTIMATE, PlanRigor.MEASURE,
                      PlanRigor.WISDOM_ONLY):
            # wisdom only for the WISDOM_ONLY column: MEASURE with wisdom
            # attached would short-circuit the sweep (fftw semantics) and
            # report wisdom-lookup time instead of the honest Fig. 4-5 cost
            spec = replace(SPEC, repetitions=reps, rigor=rigor.value,
                           wisdom=wpath if rigor is PlanRigor.WISDOM_ONLY
                           else None)
            _emit_rigor(rigor.value, run_suite(spec, session))
    if os.path.exists(FITTED_TABLE):
        spec = replace(SPEC, repetitions=reps,
                       rigor=PlanRigor.ESTIMATE.value,
                       costmodel=FITTED_TABLE)
        _emit_rigor("estimate_fitted", run_suite(spec, session))
