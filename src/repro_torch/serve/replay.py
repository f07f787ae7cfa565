"""Traffic replay: a seeded, Zipf-distributed request mix at a configurable
arrival rate — the serving analogue of a SuiteSpec.

gearshifft (and the offline tables) measure one problem at a time on a
quiet device; a service sees a *mix*.  :class:`TrafficSpec` describes that
mix declaratively, with the same round-trip discipline as SuiteSpec:

* the mix is the cross product shapes x kinds x precisions, ranked in
  declaration order and weighted by a Zipf law ``P(rank k) ∝ k^-s`` — a
  handful of hot shapes dominating a long tail, which is what production
  FFT traffic (and LM serving traffic) looks like;
* arrivals follow a seeded Poisson process at ``rate_hz`` (exponential
  inter-arrival gaps); ``rate_hz = 0`` degenerates to a burst — every
  request submitted as fast as the queue accepts, the closed-loop mode the
  coalescing benchmark uses;
* everything is seeded: the same spec replays the same request sequence,
  so tail-latency numbers are comparable across PRs.

``replay()`` drives a running :class:`~repro_torch.serve.engine.FFTService` with
the spec and returns a :class:`ReplayReport` carrying the service metrics
snapshot (p50/p95/p99, sustained GiB/s, coalesce + cache counters) plus
per-mix-entry breakdowns.

``chaos_replay()`` is the fault-tolerance variant: the spec carries a
seeded :class:`~repro_torch.serve.faults.FaultPlan` (``faults=``), the replay
runs under injection, and the :class:`ChaosReport` grades the outcome —
delivered-success rate over the *non-poisoned* requests (a poisoned
request is one an unbounded error rule targets; nothing can save it),
tail-latency inflation against an optional clean baseline, and zero-wedge
invariants.  The grid's chaos mode (``bench_grid --serve --chaos``) is
just this with fixed seeds.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, fields
from typing import Iterator, Optional

import numpy as np

from ..core.client import KINDS, PRECISIONS, Problem
from ..core.extents import format_extents, parse_extents
from .request import FFTRequest


@dataclass(frozen=True)
class TrafficSpec:
    """One serving workload: what arrives, how often, in what proportions."""

    extents: tuple[tuple[int, ...], ...] = ((1024,), (4096,), (256, 256))
    kinds: tuple[str, ...] = ("Outplace_Complex",)
    precisions: tuple[str, ...] = ("float",)
    requests: int = 256          # total requests to replay
    rate_hz: float = 0.0         # Poisson arrival rate; 0 = closed-loop burst
    zipf_s: float = 1.1          # mix skew: P(rank k) ∝ k^-s
    batch: int = 1               # rows per request
    seed: int = 2017
    timeout_ms: Optional[float] = None   # per-request deadline
    faults: tuple = ()           # FaultRule dicts: chaos injection schedule

    def __post_init__(self):
        norm = object.__setattr__
        norm(self, "extents", tuple(
            parse_extents(e) if isinstance(e, str) else tuple(int(v) for v in e)
            for e in self.extents))
        norm(self, "kinds", tuple(self.kinds))
        norm(self, "precisions", tuple(self.precisions))
        # validate + normalize fault rules to plain dicts (JSON-ready, same
        # round-trip discipline as the rest of the spec)
        from .faults import FaultRule
        norm(self, "faults", tuple(
            (r if isinstance(r, FaultRule)
             else FaultRule.from_dict(dict(r))).to_dict()
            for r in self.faults))
        if not self.extents:
            raise ValueError("traffic spec needs at least one extent")
        bad = set(self.kinds) - set(KINDS)
        if bad:
            raise ValueError(f"unknown kind(s) {sorted(bad)}; known: {KINDS}")
        bad = set(self.precisions) - set(PRECISIONS)
        if bad:
            raise ValueError(f"unknown precision(s) {sorted(bad)}; "
                             f"known: {PRECISIONS}")
        if self.requests < 1:
            raise ValueError(f"requests must be >= 1, got {self.requests}")
        if self.rate_hz < 0 or self.zipf_s < 0 or self.batch < 1:
            raise ValueError(f"bad traffic parameters: rate_hz={self.rate_hz}"
                             f" zipf_s={self.zipf_s} batch={self.batch}")

    # --- the mix ------------------------------------------------------------
    def mix(self) -> list[tuple[tuple[int, ...], str, str]]:
        """The ranked (extents, kind, precision) entries, hottest first —
        declaration order is popularity order."""
        return [(e, k, p) for e in self.extents
                for k in self.kinds for p in self.precisions]

    def weights(self) -> np.ndarray:
        """Zipf weights over :meth:`mix`, normalized."""
        n = len(self.mix())
        w = np.arange(1, n + 1, dtype=np.float64) ** -self.zipf_s
        return w / w.sum()

    def schedule(self) -> Iterator[tuple[float, tuple[int, ...], str, str]]:
        """The deterministic replay tape: ``(t_arrival_s, extents, kind,
        precision)`` per request.  Arrival gaps are exponential at
        ``rate_hz`` (all zero for a burst)."""
        rng = np.random.default_rng(self.seed)
        mix = self.mix()
        w = self.weights()
        t = 0.0
        for _ in range(self.requests):
            if self.rate_hz > 0:
                t += float(rng.exponential(1.0 / self.rate_hz))
            idx = int(rng.choice(len(mix), p=w))
            yield t, *mix[idx]

    def fault_plan(self):
        """The spec's injection schedule as a live (counter-carrying)
        FaultPlan — build a fresh one per replay so nth-call windows start
        from zero."""
        from .faults import FaultPlan
        return FaultPlan(self.faults, seed=self.seed)

    # --- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        d = {"extents": [format_extents(e) for e in self.extents],
             "kinds": list(self.kinds), "precisions": list(self.precisions),
             "requests": self.requests, "rate_hz": self.rate_hz,
             "zipf_s": self.zipf_s, "batch": self.batch, "seed": self.seed}
        if self.timeout_ms is not None:
            d["timeout_ms"] = self.timeout_ms
        if self.faults:
            d["faults"] = [dict(r) for r in self.faults]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TrafficSpec":
        d = dict(d)
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown TrafficSpec key(s) {sorted(unknown)}; "
                             f"known: {', '.join(sorted(known))}")
        return cls(**d)


def _payloads(spec: TrafficSpec) -> dict:
    """One pre-generated host payload per mix entry (generating fresh noise
    per request would bottleneck the replay loop, not the service)."""
    rng = np.random.default_rng(spec.seed + 1)
    out = {}
    for ext, kind, prec in spec.mix():
        problem = Problem(ext, kind, prec, batch=spec.batch)
        shape = (spec.batch, *ext)
        x = rng.standard_normal(shape).astype(problem.real_dtype)
        if problem.complex_input:
            x = (x + 1j * rng.standard_normal(shape)).astype(
                problem.input_dtype)
        out[(ext, kind, prec)] = x
    return out


@dataclass
class ReplayReport:
    """What a replay measured: the service metrics snapshot + breakdowns."""

    traffic: dict                 # the TrafficSpec, as plain data
    service: dict                 # ServiceMetrics.snapshot()
    wall_s: float
    per_mix: list[dict] = field(default_factory=list)
    requests: list[FFTRequest] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"traffic": self.traffic, "service": self.service,
                "wall_s": self.wall_s, "per_mix": self.per_mix}


def replay(service, spec: TrafficSpec,
           wait_timeout_s: float = 120.0) -> ReplayReport:
    """Drive a *running* service with the spec's request tape.

    Open-loop when ``rate_hz > 0``: each request is submitted at its
    scheduled arrival time (sleeping between arrivals), so queueing delay
    under overload shows up in the latency percentiles instead of being
    absorbed by the submitting loop.  Burst mode otherwise.
    """
    from ..core.results import percentile_summary

    payloads = _payloads(spec)
    submitted: list[FFTRequest] = []
    t0 = time.perf_counter()
    for t_arr, ext, kind, prec in spec.schedule():
        if spec.rate_hz > 0:
            now = time.perf_counter() - t0
            if t_arr > now:
                time.sleep(t_arr - now)
        req = service.submit(payloads[(ext, kind, prec)], kind=kind,
                             precision=prec,
                             rank=len(ext),
                             timeout_ms=spec.timeout_ms)
        submitted.append(req)
    for req in submitted:
        try:
            req.result(timeout=wait_timeout_s)
        except Exception:
            pass   # failures are recorded on the request / in the metrics
    wall = time.perf_counter() - t0

    per_mix = []
    by_key: dict[tuple, list[FFTRequest]] = {}
    for req in submitted:
        by_key.setdefault(req.plan_key, []).append(req)
    for (ext, kind, prec) in spec.mix():
        reqs = by_key.get((ext, kind, prec))
        if not reqs:
            continue
        lats = [r.latency_ms for r in reqs if r.ok]
        entry = {"extents": format_extents(ext), "kind": kind,
                 "precision": prec, "requests": len(reqs),
                 "failed": sum(1 for r in reqs if not r.ok)}
        if lats:
            entry["latency_ms"] = {"mean": float(np.mean(lats)),
                                   **percentile_summary(lats)}
        per_mix.append(entry)
    return ReplayReport(traffic=spec.to_dict(), service=service.report(),
                        wall_s=wall, per_mix=per_mix, requests=submitted)


@dataclass
class ChaosReport:
    """A graded chaos replay: the ordinary replay report plus the
    fault-tolerance verdict.

    ``clean_success_rate`` is the number the acceptance gate watches: of
    the requests *no injected fault dooms outright* (see
    :meth:`FaultPlan.is_poison`), what fraction still delivered a result —
    through fallback, retry, bisection, or watchdog recovery.  ``violations``
    is empty when every invariant held; each entry is a human-readable
    sentence naming the broken one.
    """

    replay: ReplayReport
    faults: dict                     # FaultPlan.snapshot() after the run
    total: int = 0
    poisoned: int = 0                # requests no recovery could save
    clean_ok: int = 0                # non-poisoned requests that succeeded
    success_rate: float = 0.0        # over all requests
    clean_success_rate: float = 0.0  # over non-poisoned requests
    violations: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {**self.replay.to_dict(), "faults": self.faults,
                "total": self.total, "poisoned": self.poisoned,
                "clean_ok": self.clean_ok,
                "success_rate": self.success_rate,
                "clean_success_rate": self.clean_success_rate,
                "violations": list(self.violations), "ok": self.ok}


def chaos_replay(service, spec: TrafficSpec, wait_timeout_s: float = 120.0,
                 min_clean_success: float = 1.0,
                 baseline_p99_ms: Optional[float] = None,
                 max_p99_inflation: float = 50.0) -> ChaosReport:
    """Replay ``spec`` under its fault schedule and grade the recovery.

    The spec's ``faults`` become the service's live FaultPlan (unless the
    service already carries one — e.g. rid-pinned poison rules built after
    request creation).  Invariants checked:

    * ``clean_success_rate >= min_clean_success`` — every request the fault
      schedule didn't doom outright must still be served;
    * no wedged workers, and no worker error that isn't an injected kill
      (the engine must degrade, not die);
    * optionally, delivered p99 latency stays within ``max_p99_inflation``×
      a fault-free ``baseline_p99_ms`` (off unless a baseline is given).
    """
    plan = service.fault_plan
    if plan is None or (not plan and spec.faults):
        plan = spec.fault_plan()
        service.fault_plan = plan
    rep = replay(service, spec, wait_timeout_s=wait_timeout_s)

    total = len(rep.requests)
    poisoned = clean_ok = ok_all = 0
    for req in rep.requests:
        doomed = plan is not None and plan.is_poison(req.extents, req.kind,
                                                     rid=req.rid)
        if req.ok:
            ok_all += 1
        if doomed:
            poisoned += 1
        elif req.ok:
            clean_ok += 1
    clean_total = total - poisoned
    success_rate = ok_all / total if total else 0.0
    clean_rate = clean_ok / clean_total if clean_total else 1.0

    violations: list[str] = []
    snap = rep.service
    if clean_rate < min_clean_success:
        violations.append(
            f"clean success rate {clean_rate:.3f} below required "
            f"{min_clean_success:.3f} ({clean_ok}/{clean_total} non-poisoned "
            f"requests delivered)")
    if snap.get("wedged", 0):
        violations.append(f"{snap['wedged']} worker(s) wedged")
    stray = [e for e in snap.get("worker_errors", ())
             if not e.startswith("WorkerKilled")]
    if stray:
        violations.append(f"unexpected worker error(s): {stray}")
    if baseline_p99_ms is not None and "latency_ms" in snap:
        p99 = snap["latency_ms"]["p99"]
        if p99 > baseline_p99_ms * max_p99_inflation:
            violations.append(
                f"p99 {p99:.1f} ms exceeds {max_p99_inflation:.0f}x the "
                f"fault-free baseline ({baseline_p99_ms:.1f} ms)")

    return ChaosReport(replay=rep,
                       faults=plan.snapshot() if plan is not None else {},
                       total=total, poisoned=poisoned, clean_ok=clean_ok,
                       success_rate=success_rate,
                       clean_success_rate=clean_rate, violations=violations)
