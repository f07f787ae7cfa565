"""Fit per-device cost-model coefficients from measured trajectory data
(the reference's ``tools/fit_costmodel.py`` over the port's model).

ESTIMATE ranks candidates by the hand-written bytes-moved table of
``core/costmodel.py`` (the reference's pass counts, with the port's
Hopper caps and ``kernel_passes``).  This regresses that table against
measured time: it pools every (problem, backend, time) observation it can
find, the grid rows of BENCH documents (``benchmarks/bench_grid.py``) and
the ``measured_ms`` of schema-v3 wisdom packs
(``benchmarks/pregen_wisdom.py``), and calibrates one multiplicative
scale a backend and device kind: the median measured-time over
modeled-bytes ratio on the training half, over the ``xla`` backend's
(the vendor path: ``torch.fft`` on the port), so the coefficients stay in
device-memory-pass units.  Scaling whole backends keeps each backend's
inner structure (chirp padding ratios, per-stage growth) and fixes what
the hand-written table gets wrong on a device.

Quality is the Spearman rank correlation between modeled cost and
measured time on a deterministic held-out half (alternating over the
sorted observation keys), per device kind and extent class, for the
hand-written and the fitted table: ESTIMATE only ever orders candidates.

    PYTHONPATH=src python -m repro_torch.benchmarks.fit_costmodel \\
        BENCH_h100.json --wisdom wisdom_h100.json \\
        --out costmodel_h100.json \\
        --assert-improves --assert-kind "NVIDIA H100 80GB HBM3"

The output is the versioned table ``core/costmodel.py``'s
``load_tables`` / ``model_for_device`` read; a ``SuiteSpec.costmodel``
path (the CLI's ``--config``) installs it for a run.  Its meta names the
devices the inputs were measured on, with their power limits.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
from collections import defaultdict
from dataclasses import dataclass

from ..core.candidates import Candidate
from ..core.client import Problem
from ..core.compare import BenchFormatError, load_bench
from ..core.costmodel import (BACKEND_COEFFS, DEFAULT_MODEL, CostModel,
                              save_tables, spearman)
from ..core.extents import classify, parse_extents
from ..core.wisdom import Wisdom


@dataclass(frozen=True)
class Obs:
    """One measured observation the fitter can learn from."""

    device_kind: str
    extent_class: str
    backend: str
    problem: Problem
    cand: Candidate
    time_ms: float
    origin: str       # file the measurement came from, for the report

    def key(self) -> tuple:
        return (self.device_kind, self.extent_class, self.backend,
                self.problem.signature(), self.origin)


# ---------------------------------------------------------------------------
# observation collection
# ---------------------------------------------------------------------------
def bench_observations(paths: list[str]) -> tuple[list[Obs], dict]:
    """Grid rows of BENCH documents as observations.

    Serve/chaos rows (no fixed problem), multi-device rows, failed rows
    and backends without fittable coefficients are skipped; the skip
    census is returned for the report, so dropped coverage is visible.
    """
    obs: list[Obs] = []
    skipped: dict[str, int] = defaultdict(int)
    for path in paths:
        doc = load_bench(path)
        kind = str(doc.meta.get("device_kind", "") or "unknown")
        meta_batch = int(doc.meta.get("batch", 1) or 1)
        for row in doc.rows:
            if row.get("mode") != "grid":
                skipped["non-grid row (serve/chaos)"] += 1
                continue
            if not row.get("ok"):
                skipped["failed row"] += 1
                continue
            if int(row.get("devices", 1)) != 1:
                skipped["multi-device row"] += 1
                continue
            t = row.get("time_ms")
            if not isinstance(t, (int, float)) or not math.isfinite(t) \
                    or t <= 0:
                skipped["bad time_ms"] += 1
                continue
            backend = str(row.get("backend", ""))
            if backend not in BACKEND_COEFFS:
                skipped[f"backend without coefficients ({backend})"] += 1
                continue
            try:
                problem = Problem(parse_extents(str(row["extent"])),
                                  row["kind"], row["precision"],
                                  batch=int(row.get("batch", meta_batch)))
            except (KeyError, ValueError):
                skipped["unparseable problem"] += 1
                continue
            obs.append(Obs(kind, classify(problem.extents), backend,
                           problem, Candidate(backend), float(t),
                           doc.label))
    return obs, dict(skipped)


def wisdom_observations(paths: list[str]) -> tuple[list[Obs], dict]:
    """``measured_ms`` of schema-v3 wisdom packs.  A pack's keys embed the
    device kind they were measured on, so the kinds are read from the raw
    file and a store opened per kind.  Per-axis (``nd``) and mesh
    candidates are skipped: their cost is not one backend's."""
    obs: list[Obs] = []
    skipped: dict[str, int] = defaultdict(int)
    for path in paths:
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, json.JSONDecodeError):
            skipped[f"unreadable wisdom file ({os.path.basename(path)})"] += 1
            continue
        kinds = sorted({k.split("|", 1)[0] for k in raw
                        if isinstance(k, str) and "|" in k
                        and not k.startswith("__")})
        for kind in kinds:
            store = Wisdom(path, device_kind=kind)
            for problem, cand, ms in store.measurements():
                if not math.isfinite(ms) or ms <= 0:
                    skipped["bad measured_ms"] += 1
                    continue
                if cand.backend not in BACKEND_COEFFS or cand.mesh:
                    skipped[f"unfittable candidate ({cand.backend})"] += 1
                    continue
                obs.append(Obs(kind, classify(problem.extents),
                               cand.backend, problem, cand, float(ms),
                               os.path.basename(path)))
    return obs, dict(skipped)


def predictable(obs: list[Obs]) -> tuple[list[Obs], int]:
    """Drop observations the model calls infeasible (feasibility is
    structural, so a row infeasible under the defaults is infeasible under
    any fit)."""
    kept, dropped = [], 0
    for o in obs:
        if math.isfinite(DEFAULT_MODEL.estimate_bytes_moved(o.problem,
                                                            o.cand)):
            kept.append(o)
        else:
            dropped += 1
    return kept, dropped


# ---------------------------------------------------------------------------
# fitting and evaluation
# ---------------------------------------------------------------------------
def split_train_test(obs: list[Obs]) -> tuple[list[Obs], list[Obs]]:
    """Deterministic alternating held-out split over the sorted keys:
    stable across runs, and every (backend, class) stratum lands in both
    halves once it has two observations."""
    ordered = sorted(obs, key=Obs.key)
    return ordered[0::2], ordered[1::2]


def fit_scales(train: list[Obs]) -> dict[str, float]:
    """Per-backend multiplicative scale for one device kind: median(time /
    modeled bytes) a backend, over the ``xla`` backend's (or the median
    of all where it is absent)."""
    ratios: dict[str, list[float]] = defaultdict(list)
    for o in train:
        pred = DEFAULT_MODEL.estimate_bytes_moved(o.problem, o.cand)
        ratios[o.backend].append(o.time_ms / pred)
    scales = {b: statistics.median(r) for b, r in sorted(ratios.items())}
    if not scales:
        return {}
    ref = scales.get("xla") or statistics.median(scales.values())
    return {b: s / ref for b, s in scales.items()}


def rho_report(test: list[Obs], model: CostModel) -> dict:
    """Held-out Spearman between modeled cost and measured time, pooled
    per device kind and broken out per extent class."""
    by_kind: dict[str, list[Obs]] = defaultdict(list)
    for o in test:
        by_kind[o.device_kind].append(o)
    out: dict[str, dict] = {}
    for kind, rows in sorted(by_kind.items()):
        preds = [model.estimate_bytes_moved(o.problem, o.cand)
                 for o in rows]
        times = [o.time_ms for o in rows]
        entry = {"rho": spearman(preds, times), "n": len(rows),
                 "classes": {}}
        by_cls: dict[str, list[Obs]] = defaultdict(list)
        for o in rows:
            by_cls[o.extent_class].append(o)
        for cls, crows in sorted(by_cls.items()):
            entry["classes"][cls] = {
                "rho": spearman(
                    [model.estimate_bytes_moved(o.problem, o.cand)
                     for o in crows],
                    [o.time_ms for o in crows]),
                "n": len(crows)}
        out[kind] = entry
    return out


def _fmt_rho(v: float) -> str:
    return "nan" if math.isnan(v) else f"{v:+.3f}"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="fit cost-model coefficients from BENCH + wisdom data")
    ap.add_argument("bench", nargs="+", help="BENCH_*.json documents")
    ap.add_argument("--wisdom", action="append", default=[],
                    help="schema-v3 wisdom pack(s) with measured_ms rows")
    ap.add_argument("--out", help="write the fitted coefficient table here")
    ap.add_argument("--assert-min-rho", type=float, default=None,
                    metavar="RHO",
                    help="exit 1 unless fitted held-out rho >= RHO")
    ap.add_argument("--assert-improves", action="store_true",
                    help="exit 1 unless fitted rho strictly beats the "
                         "hand-written table's")
    ap.add_argument("--assert-kind", default=None, metavar="KIND",
                    help="device kind the assertions apply to "
                         "(default: every fitted kind)")
    args = ap.parse_args(argv)

    try:
        bench_obs, bench_skips = bench_observations(args.bench)
        power = {}
        for path in args.bench:
            meta = load_bench(path).meta
            power.setdefault(meta["device_kind"], meta.get("power_limit"))
    except BenchFormatError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    wis_obs, wis_skips = wisdom_observations(args.wisdom)
    obs, infeasible = predictable(bench_obs + wis_obs)

    print(f"observations: {len(bench_obs)} bench + {len(wis_obs)} wisdom, "
          f"{infeasible} infeasible-under-model dropped")
    for why, n in sorted({**bench_skips, **wis_skips}.items()):
        print(f"  skipped {n:4d}  {why}")
    if not obs:
        print("error: no usable observations", file=sys.stderr)
        return 2

    train, test = split_train_test(obs)
    by_kind_train: dict[str, list[Obs]] = defaultdict(list)
    for o in train:
        by_kind_train[o.device_kind].append(o)

    models: dict[str, CostModel] = {}
    all_scales: dict[str, dict[str, float]] = {}
    for kind, rows in sorted(by_kind_train.items()):
        scales = fit_scales(rows)
        all_scales[kind] = scales
        models[kind] = DEFAULT_MODEL.scaled(
            scales, device_kind=kind,
            source="repro_torch.benchmarks.fit_costmodel")

    default_rho = rho_report(test, DEFAULT_MODEL)
    fitted_rho = {kind: rho_report([o for o in test
                                    if o.device_kind == kind],
                                   model).get(kind, {})
                  for kind, model in models.items()}

    print(f"\nheld-out split: {len(train)} train / {len(test)} test")
    for kind in sorted(models):
        d = default_rho.get(kind, {})
        f = fitted_rho.get(kind, {})
        print(f"\ndevice kind {kind!r}  "
              f"(n={f.get('n', 0)} held-out)")
        print(f"  pooled rho   hand-written {_fmt_rho(d.get('rho', float('nan')))}"
              f"   fitted {_fmt_rho(f.get('rho', float('nan')))}")
        classes = sorted(set(d.get("classes", {})) | set(f.get("classes", {})))
        for cls in classes:
            dc = d.get("classes", {}).get(cls, {})
            fc = f.get("classes", {}).get(cls, {})
            print(f"  {cls:<10} rho  hand-written "
                  f"{_fmt_rho(dc.get('rho', float('nan')))}   fitted "
                  f"{_fmt_rho(fc.get('rho', float('nan')))}   "
                  f"(n={fc.get('n', 0)})")
        print("  backend scales: "
              + ", ".join(f"{b}={s:.3g}"
                          for b, s in all_scales[kind].items()))

    if args.out:
        meta = {
            "generated_by": "repro_torch.benchmarks.fit_costmodel",
            "inputs": sorted(os.path.basename(p)
                             for p in args.bench + args.wisdom),
            "power_limits": power,
            "observations": len(obs),
            "backend_scales": all_scales,
            "held_out_rho": {
                kind: {"hand_written": default_rho.get(kind, {}).get("rho"),
                       "fitted": fitted_rho.get(kind, {}).get("rho"),
                       "n": fitted_rho.get(kind, {}).get("n")}
                for kind in sorted(models)},
        }
        save_tables(args.out, models, meta=meta)
        print(f"\nwrote {args.out} ({len(models)} device kind(s))")

    failures = []
    kinds = [args.assert_kind] if args.assert_kind else sorted(models)
    for kind in kinds:
        f_rho = fitted_rho.get(kind, {}).get("rho", float("nan"))
        d_rho = default_rho.get(kind, {}).get("rho", float("nan"))
        if args.assert_min_rho is not None and \
                not (f_rho >= args.assert_min_rho):
            failures.append(
                f"{kind}: fitted rho {_fmt_rho(f_rho)} < "
                f"required {args.assert_min_rho}")
        if args.assert_improves and not (f_rho > d_rho):
            failures.append(
                f"{kind}: fitted rho {_fmt_rho(f_rho)} does not strictly "
                f"improve on hand-written {_fmt_rho(d_rho)}")
    for msg in failures:
        print(f"ASSERTION FAILED: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
