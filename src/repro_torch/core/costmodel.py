"""The planner's bytes-moved cost model (ESTIMATE), as a fittable table.

The reference package's model with its coefficients unchanged: the
:class:`CostCoefficients` defaults are the reference's, bit for bit, and a
coefficient-table file (``load_tables``/``save_tables``) written by either
package reads the same in the other.  A table fitted on the card
(``benchmarks/fit_costmodel.py``: one scale a backend, through
:data:`BACKEND_COEFFS` and :meth:`CostModel.scaled`) is opt-in through
``SuiteSpec.costmodel``; without one ESTIMATE ranks by the hand-written
pass counts.

Two things differ, both for Hopper:

* a kernel's passes depend on whether one block holds the signal, which
  depends on the precision (the Stockham kernel holds 14406 complex64 or
  7203 complex128 points in one block, the four-step kernel every split
  in complex64 and up to 13920 points in complex128, the fused rank-2
  kernel 8192 / 4096 points); above that the kernel runs as two passes
  through global memory and is priced at two round trips
  (:func:`.candidates.kernel_passes`), where the reference prices
  ``stockham_pallas`` with a VMEM budget apart from its cap.  So
  :meth:`CostModel.hbm_passes` takes the precision, and
  :meth:`CostModel.estimate` passes the problem's.  The composed paths
  (``sixstep``, ``chirpz_pallas``, ``bluestein``) keep the reference's
  pass counts: the passes of the kernels under them (a padded chirp
  length over one block, the four-step kernel's two complex128 launches
  at n2 = 16384) are not priced, so their ESTIMATE picks are the
  reference's.

Distributed candidates (``dist1d``, ``slab``, ``pencil``) are priced per
rank, as in the reference: the local engines' passes on the 1/P block,
plus each all_to_all's block at ``dist_link_cost`` bytes per byte and a
fixed ``dist_a2a_latency_bytes``.

A module-level *active* model (:func:`get_active_model`,
:func:`set_active_model`, :func:`use_model`) is what ``hbm_passes``,
``estimate_bytes_moved`` and ``estimate_choice`` consult, so a Session that
installs a table re-ranks ESTIMATE picks and per-axis pruning at once.
An infeasible assignment gets a typed :class:`Infeasible` verdict from
:meth:`CostModel.estimate` (its ``float()`` is ``inf``, which is what
``estimate_bytes_moved`` returns).
"""

from __future__ import annotations

import json
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, fields, replace
from typing import Optional

from ..fft.bluestein import PALLAS_SINGLE_MAX_M
from .candidates import (BACKENDS, DIST_A2A_COUNT, DIST_BACKENDS,
                         DIST_NATURAL_EXTRA, FUSED_ND, SIXSTEP_MIN_N,
                         Candidate, _smooth7, axis_elems, axis_engine_n,
                         axis_feasible, candidates, dist_local_lengths,
                         dist_supports, fft2_feasible, fft2_passes,
                         kernel_passes)
from .client import Problem
from .extents import next_pow2 as _next_pow2, next_smooth

#: Schema stamped into coefficient-table files; loaders reject others.
COSTMODEL_SCHEMA_VERSION = 1


@dataclass(frozen=True)
class Infeasible:
    """Typed infeasibility verdict from :meth:`CostModel.estimate`.

    Falsy, and ``float()`` of it is ``inf``: numeric callers keep their
    sentinel, while a report (the bench grid's roofline) can say why a row
    had no modeled traffic.
    """

    reason: str = ""

    def __bool__(self) -> bool:
        return False

    def __float__(self) -> float:
        return float("inf")


@dataclass(frozen=True)
class CostCoefficients:
    """Every fittable constant of the bytes-moved model, with the
    reference's hand-written values as defaults (the distributed and
    chirp ones too, so a table file round-trips whole)."""

    xla_smooth_passes: float = 2.0
    xla_chirp_passes: float = 6.0
    stockham_stage_passes: float = 1.0
    fourstep_level_passes: float = 2.0
    dft_passes: float = 1.0
    fourstep_pallas_passes: float = 1.0
    stockham_pallas_passes: float = 1.0
    sixstep_passes: float = 5.0
    chirpz_smooth_passes: float = 5.0
    chirpz_pow2_passes: float = 13.0
    bluestein_stage_passes: float = 3.0
    bluestein_setup_passes: float = 2.0
    transpose_passes: float = 2.0
    dist_link_cost: float = 4.0
    dist_a2a_latency_bytes: float = float(1 << 20)
    dist1d_twiddle_passes: float = 1.0
    # rank-1 problems at or below this inner engine length go straight to
    # the single-product dft kernel
    dft_pin_max_n: int = 128

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "CostCoefficients":
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            warnings.warn(f"ignoring unknown cost coefficients: {unknown}")
        return cls(**{k: (int(v) if k == "dft_pin_max_n" else float(v))
                      for k, v in d.items() if k in known})


DEFAULT_COEFFICIENTS = CostCoefficients()

#: Which coefficients a measured row of each backend calibrates: the fitter
#: scales them together, so the structure inside a backend (the chirp
#: smooth against power-of-two overhead) is kept.  ``fft2_pallas`` has
#: none (ESTIMATE prices it by its passes), and the dft pin is a rule.
BACKEND_COEFFS = {
    "xla": ("xla_smooth_passes", "xla_chirp_passes"),
    "stockham": ("stockham_stage_passes",),
    "fourstep": ("fourstep_level_passes",),
    "dft": ("dft_passes",),
    "fourstep_pallas": ("fourstep_pallas_passes",),
    "stockham_pallas": ("stockham_pallas_passes",),
    "sixstep": ("sixstep_passes",),
    "chirpz_pallas": ("chirpz_smooth_passes", "chirpz_pow2_passes"),
    "bluestein": ("bluestein_stage_passes", "bluestein_setup_passes"),
}


class CostModel:
    """Bytes-moved model over one :class:`CostCoefficients` table;
    ``device_kind`` labels the device it was fitted for (``"default"``: the
    hand-written table) and ``source`` its provenance."""

    def __init__(self, coeffs: CostCoefficients = DEFAULT_COEFFICIENTS,
                 device_kind: str = "default",
                 source: str = "hand-written defaults"):
        self.coeffs = coeffs
        self.device_kind = device_kind
        self.source = source

    def __repr__(self) -> str:
        return f"CostModel({self.device_kind!r}, source={self.source!r})"

    def scaled(self, backend_scales: dict[str, float],
               device_kind: str = "", source: str = "") -> "CostModel":
        """A new model with each backend's coefficients (see
        :data:`BACKEND_COEFFS`) multiplied by its fitted scale."""
        updates: dict[str, float] = {}
        for backend, scale in backend_scales.items():
            for name in BACKEND_COEFFS.get(backend, ()):
                updates[name] = getattr(self.coeffs, name) * float(scale)
        return CostModel(replace(self.coeffs, **updates),
                         device_kind or self.device_kind,
                         source or self.source)

    def hbm_passes(self, backend: str, n: int,
                   precision: str = "float") -> float:
        """Modeled device-memory round trips of the whole signal for one
        length-n transform; ``inf`` marks a choice the backend cannot run
        at this length and precision on Hopper."""
        c = self.coeffs
        if not axis_feasible(backend, n, precision):
            return float("inf")
        if backend == "xla":
            if _smooth7(n):
                return c.xla_smooth_passes
            # a non-smooth length sends the vendor library down its chirp
            # fallback at the padded power-of-two length
            return c.xla_chirp_passes * (_next_pow2(2 * n - 1) / n)
        if backend == "stockham":
            return c.stockham_stage_passes * float(max(1, n.bit_length() - 1))
        if backend == "fourstep":
            levels, m = 1, n
            while m > 128:
                m = -(-m // 128)
                levels += 1
            return c.fourstep_level_passes * levels
        if backend == "dft":
            return c.dft_passes
        if backend == "fourstep_pallas":
            return c.fourstep_pallas_passes * kernel_passes(backend, n,
                                                            precision)
        if backend == "stockham_pallas":
            return c.stockham_pallas_passes * kernel_passes(backend, n,
                                                            precision)
        if backend == "sixstep":
            # 2 kernel passes + 3 transposes; the Stockham kernel alone
            # below the smallest split is not priced, as in the reference
            return c.sixstep_passes if n >= SIXSTEP_MIN_N else float("inf")
        if backend == "chirpz_pallas":
            # two padded transforms + the chirp, filter and final chirp
            # multiplies (the filter spectrum is prebuilt), charged at the
            # padded length: the Stockham kernel's 7-smooth m, or the
            # six-step composition's power of two
            ms = next_smooth(2 * n - 1)
            if ms <= PALLAS_SINGLE_MAX_M:
                return c.chirpz_smooth_passes * (ms / n)
            return c.chirpz_pow2_passes * (_next_pow2(2 * n - 1) / n)
        if backend == "bluestein":
            m = _next_pow2(2 * n - 1)
            # 3 staged Stockham transforms of padded length m + the chirps
            return (c.bluestein_stage_passes * max(1, m.bit_length() - 1)
                    + c.bluestein_setup_passes) * (m / n)
        return float("inf")

    def estimate(self, problem: Problem,
                 cand: Candidate) -> "float | Infeasible":
        """Modeled device-memory bytes for the full transform under
        ``cand``, or an :class:`Infeasible` verdict with the reason (the
        assignment cannot run on Hopper).  Whole-transform backends move
        the signal their passes with no transpose traffic;
        separable assignments pay, per axis, the engine's passes at its
        engine length plus two transpose passes for every non-innermost
        axis, each pass reading and writing the axis's live elements."""
        c = self.coeffs
        complex_itemsize = 16 if problem.precision == "double" else 8
        if cand.backend in DIST_BACKENDS:
            return self._dist_estimate(problem, cand, complex_itemsize)
        if cand.backend in FUSED_ND:
            elems = axis_elems(problem, problem.rank - 1)
            if cand.backend == "xla":
                passes = max(self.hbm_passes("xla", axis_engine_n(problem, i))
                             for i in range(problem.rank))
            else:   # fft2_pallas: one read + one write of the tile a pass
                if not fft2_feasible(problem):
                    return Infeasible(f"fft2_pallas cannot take "
                                      f"{problem.signature()}")
                passes = float(fft2_passes(problem))
            return passes * 2.0 * elems * complex_itemsize
        total = 0.0
        for axis, ax_cand in enumerate(cand.per_axis(problem.rank)):
            n_eng = axis_engine_n(problem, axis)
            passes = self.hbm_passes(ax_cand.backend, n_eng,
                                     problem.precision)
            if passes == float("inf"):
                return Infeasible(
                    f"{ax_cand.backend} infeasible at engine length "
                    f"{n_eng} (axis {axis} of {problem.signature()})")
            if axis != problem.rank - 1:
                passes += c.transpose_passes
            total += (passes * 2.0 * axis_elems(problem, axis)
                      * complex_itemsize)
        return total

    def _dist_estimate(self, problem: Problem, cand: Candidate,
                       complex_itemsize: int) -> "float | Infeasible":
        """Per-rank bytes of a distributed candidate: the local engines'
        passes (and their transposes) on the rank's 1/P block, the
        dist1d twiddle, and each all_to_all's block at the link cost plus
        its fixed latency."""
        c = self.coeffs
        if not dist_supports(cand.backend, problem, cand.mesh):
            return Infeasible(f"{cand.key()} cannot decompose "
                              f"{problem.signature()} over mesh {cand.mesh}")
        p = 1
        for s in cand.mesh:
            p *= s
        opts = cand.opts()
        forced = opts.get("local")
        passes = 0.0
        for n_g, swaps in dist_local_lengths(problem, cand):
            b = forced or self.dist_local_engine(n_g)
            hp = self.hbm_passes(b, n_g)
            if hp == float("inf"):
                return Infeasible(f"local engine {b} infeasible at n={n_g}")
            passes += hp + swaps
        if cand.backend == "dist1d":
            passes += c.dist1d_twiddle_passes
        dev_bytes = (problem.n_elems / p) * complex_itemsize
        n_a2a = DIST_A2A_COUNT[cand.backend]
        if opts.get("natural"):
            n_a2a += DIST_NATURAL_EXTRA[cand.backend]
        return (passes * 2.0 * dev_bytes
                + n_a2a * (dev_bytes * c.dist_link_cost
                           + c.dist_a2a_latency_bytes))

    def estimate_bytes_moved(self, problem: Problem,
                             cand: Candidate) -> float:
        """Numeric view of :meth:`estimate`: infeasible is ``inf``."""
        return float(self.estimate(problem, cand))

    def dist_local_engine(self, n: int) -> str:
        """The separable backend a distributed plan runs locally at length
        ``n`` when no ``local`` knob forces one: the fewest modeled
        passes, ties to the earlier :data:`BACKENDS` entry."""
        best, best_p = "fourstep", float("inf")
        for b in BACKENDS:
            if b in FUSED_ND:
                continue
            passes = self.hbm_passes(b, n)
            if passes < best_p:
                best, best_p = b, passes
        return best

    def estimate_choice(self, problem: Problem) -> Candidate:
        """The ESTIMATE heuristic: tiny rank-1 problems go straight to the
        dft kernel (launch overhead dominates traffic there); everything
        else takes the candidate that moves the fewest modeled bytes, ties
        keeping the earlier entry (the vendor path first, per-axis
        assignments last)."""
        cands = candidates(problem)
        by_backend = {c.backend: c for c in cands}
        if "dft" in by_backend and problem.rank == 1 \
                and problem.extents[-1] <= self.coeffs.dft_pin_max_n:
            return by_backend["dft"]
        best, best_cost = None, float("inf")
        for c in cands:
            cost = self.estimate_bytes_moved(problem, c)
            if cost < best_cost:
                best, best_cost = c, cost
        if best is not None:
            return best
        return by_backend.get("xla", by_backend["bluestein"])


#: The hand-written model, installed by default.
DEFAULT_MODEL = CostModel()

_active_model: CostModel = DEFAULT_MODEL


def get_active_model() -> CostModel:
    """The model the planner consults."""
    return _active_model


def set_active_model(model: Optional[CostModel]) -> CostModel:
    """Install ``model`` (None restores the default); returns the previous
    active model."""
    global _active_model
    prev = _active_model
    _active_model = model if model is not None else DEFAULT_MODEL
    return prev


@contextmanager
def use_model(model: Optional[CostModel]):
    """Scoped :func:`set_active_model`: a Session installs its device's
    table for the duration of a run and restores the previous one."""
    prev = set_active_model(model)
    try:
        yield get_active_model()
    finally:
        set_active_model(prev)


def hbm_passes(backend: str, n: int, precision: str = "float") -> float:
    return get_active_model().hbm_passes(backend, n, precision)


def estimate_bytes_moved(problem: Problem, cand: Candidate) -> float:
    return get_active_model().estimate_bytes_moved(problem, cand)


def estimate_choice(problem: Problem) -> Candidate:
    return get_active_model().estimate_choice(problem)


def dist_local_engine(n: int) -> str:
    return get_active_model().dist_local_engine(n)


def load_tables(path: str) -> dict[str, CostModel]:
    """Load a coefficient-table file (``{"schema": 1, "tables":
    {device_kind: {coeff: value}}, ...}``); raises on another schema."""
    with open(path) as f:
        doc = json.load(f)
    schema = doc.get("schema")
    if schema != COSTMODEL_SCHEMA_VERSION:
        raise ValueError(
            f"cost-model table {path} has schema {schema!r}; this reader "
            f"understands v{COSTMODEL_SCHEMA_VERSION}")
    source = doc.get("generated_by", path)
    return {kind: CostModel(CostCoefficients.from_dict(tbl), kind,
                            source=f"{source} [{kind}]")
            for kind, tbl in doc.get("tables", {}).items()}


def save_tables(path: str, models: dict[str, CostModel],
                meta: Optional[dict] = None) -> None:
    doc = {"schema": COSTMODEL_SCHEMA_VERSION, **(meta or {}),
           "tables": {kind: m.coeffs.to_dict()
                      for kind, m in sorted(models.items())}}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def model_for_device(device_kind: str,
                     tables: "dict[str, CostModel] | str") -> CostModel:
    """The table for ``device_kind``: an exact match, then a
    case-insensitive prefix match, then ``"default"``, else the
    hand-written model."""
    if isinstance(tables, str):
        tables = load_tables(tables)
    if device_kind in tables:
        return tables[device_kind]
    dk = device_kind.lower()
    for kind, model in sorted(tables.items()):
        k = kind.lower()
        if k != "default" and (dk.startswith(k) or k.startswith(dk)):
            return model
    return tables.get("default", DEFAULT_MODEL)


def spearman(xs, ys) -> float:
    """Spearman rank correlation (ties get average ranks); nan for fewer
    than 2 points or zero variance.  The fitter's quality measure:
    ESTIMATE only ever orders candidates."""
    n = len(xs)
    if n != len(ys):
        raise ValueError(f"length mismatch: {n} vs {len(ys)}")
    if n < 2:
        return float("nan")

    def ranks(vals):
        order = sorted(range(n), key=lambda i: vals[i])
        r = [0.0] * n
        i = 0
        while i < n:
            j = i
            while j + 1 < n and vals[order[j + 1]] == vals[order[i]]:
                j += 1
            avg = (i + j) / 2.0 + 1.0
            for k in range(i, j + 1):
                r[order[k]] = avg
            i = j + 1
        return r

    rx, ry = ranks(list(xs)), ranks(list(ys))
    mx = sum(rx) / n
    my = sum(ry) / n
    cov = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    vx = sum((a - mx) ** 2 for a in rx)
    vy = sum((b - my) ** 2 for b in ry)
    if vx == 0.0 or vy == 0.0:
        return float("nan")
    return cov / (vx * vy) ** 0.5
