"""The port's fault-tolerance machinery against the reference package's:
FaultPlan matching and determinism, the circuit breaker (with a threaded
hammer), the planner's fallback chains and fault-tolerant ``make_plan``,
the wisdom schema-version and demotion layer, and chaos traffic specs.

Each test of ``tests/test_faults.py`` is held against the port (the
kernels run their plain versions on the CPU); beside them, the same calls
go through both packages and must give the same decisions: ``FaultPlan``
check sequences, ``CircuitBreaker`` state sequences on a patched clock,
``fallback_chain`` keys over problems of every extent class, and
``FaultRule`` dicts and validation errors.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.core.client import Problem as RProblem
from repro.serve import FaultPlan as RFaultPlan
from repro.serve import FaultRule as RFaultRule
from repro_torch.core.candidates import candidates
from repro_torch.core.client import Problem
from repro_torch.core.plan import (Candidate, CircuitBreaker, KernelError,
                                   PlanRigor, breaker_key, fallback_chain,
                                   make_plan, probe_finite, problem_class)
from repro_torch.core.wisdom import WISDOM_SCHEMA_VERSION, Wisdom
from repro_torch.serve import (FaultInjected, FaultPlan, FaultRule,
                               TrafficSpec, faulty_build)

CPU = torch.device("cpu")


def _hammer(n_threads, fn):
    errors = []
    barrier = threading.Barrier(n_threads)

    def work(i):
        try:
            barrier.wait(timeout=30)
            fn(i)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)


# ---------------------------------------------------------------------------
# FaultRule / FaultPlan
# ---------------------------------------------------------------------------
def test_fault_rule_validation_and_roundtrip():
    rule = FaultRule("compile_error", backend="stockham_pallas",
                     extents=[64], after=1, times=2)
    assert rule.extents == (64,) and rule.site == "build"
    assert FaultRule.from_dict(rule.to_dict()) == rule
    assert "backend" in rule.to_dict() and "kind" not in rule.to_dict()
    with pytest.raises(ValueError, match="unknown fault"):
        FaultRule("segfault")
    with pytest.raises(ValueError, match="bad fault window"):
        FaultRule("execute_error", after=-1)
    with pytest.raises(ValueError, match="unknown FaultRule key"):
        FaultRule.from_dict({"fault": "nan_output", "nope": 1})


RULES = [
    {"fault": "compile_error", "backend": "stockham_pallas", "extents": [64],
     "after": 1, "times": 2},
    {"fault": "nan_output", "rid": 7, "stall_ms": 3.0},
    {"fault": "kill_worker", "kind": "Outplace_Real"},
    {"fault": "latency_spike"},
]
BAD_RULES = [{"fault": "segfault"}, {"fault": "execute_error", "after": -1},
             {"fault": "execute_error", "times": -2},
             {"fault": "nan_output", "nope": 1}]


@pytest.mark.parametrize("rule", RULES)
def test_fault_rule_dicts_are_the_reference(rule):
    mine, ref = FaultRule.from_dict(rule), RFaultRule.from_dict(rule)
    assert mine.to_dict() == ref.to_dict()
    assert (mine.site, mine.extents) == (ref.site, ref.extents)


@pytest.mark.parametrize("rule", BAD_RULES)
def test_fault_rule_errors_are_the_reference(rule):
    with pytest.raises(ValueError) as mine:
        FaultRule.from_dict(rule)
    with pytest.raises(ValueError) as ref:
        RFaultRule.from_dict(rule)
    assert str(mine.value) == str(ref.value)


def test_fault_plan_nth_call_window_and_sites():
    plan = FaultPlan([
        {"fault": "execute_error", "backend": "xla", "after": 1, "times": 2},
        {"fault": "compile_error"},
    ])
    # site filtering: an execute rule never fires at build, and vice versa
    assert [r.fault for r in plan.check("build", "xla")] == ["compile_error"]
    # nth-call window: skip 1, fire 2, then exhausted
    fired = [bool(plan.check("execute", "xla")) for _ in range(5)]
    assert fired == [False, True, True, False, False]
    # backend mismatch never advances the counter
    assert plan.check("execute", "stockham") == []
    assert plan.injected == 3                      # 1 compile + 2 execute
    snap = plan.snapshot()
    assert snap["rules"][0]["matched"] == 5
    assert snap["rules"][0]["fired"] == 2
    assert FaultPlan.from_dict(plan.to_dict()).to_dict() == plan.to_dict()
    assert plan and not FaultPlan()


def test_fault_plan_decisions_are_the_reference():
    """The same rules and the same call sequence fire the same rules, in
    both packages, and end with the same snapshot."""
    rules = [{"fault": "execute_error", "backend": "xla", "after": 2,
              "times": 3},
             {"fault": "nan_output", "rid": 5},
             {"fault": "compile_error", "extents": [32], "times": 1},
             {"fault": "transfer_stall", "kind": "Outplace_Real",
              "after": 1},
             {"fault": "kill_worker", "after": 4, "times": 1}]
    rng = np.random.default_rng(4)
    sites = ("build", "dispatch", "execute")
    calls = [(sites[int(rng.integers(3))],
              ("xla", "dft", "stockham_pallas")[int(rng.integers(3))],
              ((32,), (64,), (8, 8))[int(rng.integers(3))],
              ("Outplace_Complex", "Outplace_Real")[int(rng.integers(2))],
              [int(v) for v in rng.integers(0, 8, size=2)])
             for _ in range(60)]
    mine, ref = FaultPlan(rules, seed=3), RFaultPlan(rules, seed=3)
    for site, backend, ext, kind, rids in calls:
        a = [r.to_dict() for r in mine.check(site, backend, ext, kind, rids)]
        b = [r.to_dict() for r in ref.check(site, backend, ext, kind, rids)]
        assert a == b
    assert mine.snapshot() == ref.snapshot()
    for ext, kind, rid in (((32,), "Outplace_Complex", None),
                           ((64,), "Outplace_Real", 5), ((8, 8), "x", 4)):
        assert mine.is_poison(ext, kind, rid) == ref.is_poison(ext, kind,
                                                               rid)


def test_fault_plan_rid_pinning_and_extents():
    plan = FaultPlan([{"fault": "nan_output", "rid": 7},
                      {"fault": "execute_error", "extents": [32]}])
    assert plan.check("execute", "xla", (64,), rids=[5, 6]) == []
    assert len(plan.check("execute", "xla", (64,), rids=[6, 7])) == 1
    assert len(plan.check("execute", "xla", (32,), rids=[1])) == 1
    assert len(plan.check("execute", "xla", (32,), rids=[7])) == 2


def test_fault_plan_is_poison_semantics():
    plan = FaultPlan([
        # pinned to one backend: a fallback chain escapes it -> not poison
        {"fault": "compile_error", "backend": "stockham_pallas"},
        # bounded window: retries outlast it -> not poison
        {"fault": "execute_error", "times": 2},
        # rid-pinned unbounded error: that one request is doomed
        {"fault": "nan_output", "rid": 3},
        # stalls never doom anything
        {"fault": "transfer_stall"},
    ])
    assert not plan.is_poison((64,), "Outplace_Complex")
    assert plan.is_poison((64,), "Outplace_Complex", rid=3)
    assert not plan.is_poison((64,), "Outplace_Complex", rid=4)
    # wildcard-backend unbounded error fault dooms every matching request
    doom = FaultPlan([{"fault": "execute_error", "extents": [128]}])
    assert doom.is_poison((128,), "Outplace_Complex")
    assert not doom.is_poison((64,), "Outplace_Complex")


def test_fault_plan_thread_safe_counters():
    plan = FaultPlan([{"fault": "execute_error", "after": 10, "times": 5}])
    n_threads, per_thread = 8, 25

    def work(i):
        for _ in range(per_thread):
            plan.check("execute", "xla")

    _hammer(n_threads, work)
    snap = plan.snapshot()["rules"][0]
    assert snap["matched"] == n_threads * per_thread   # no lost counts
    assert snap["fired"] == 5                          # window stays exact


def test_faulty_build_wraps_planner_build():
    problem = Problem((64,), "Outplace_Complex", "float")
    plan = FaultPlan([{"fault": "compile_error", "backend": "dft"}])
    calls = []

    def build(cand):
        calls.append(cand.backend)
        return lambda x: x

    wrapped = faulty_build(build, plan, problem)
    with pytest.raises(FaultInjected, match="injected compile error"):
        wrapped(Candidate("dft"))
    assert calls == []                       # fault fired before the build
    assert wrapped(Candidate("xla"))(1) == 1
    assert faulty_build(build, None, problem) is build


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------
def _breaker(threshold=3, cooldown=100.0, cls=CircuitBreaker):
    t = [0.0]
    return cls(threshold=threshold, cooldown_s=cooldown,
               clock=lambda: t[0]), t


def test_breaker_open_halfopen_close_lifecycle():
    b, t = _breaker()
    key = "stockham|powerof2|r1"
    assert b.allows(key) and b.state(key) == CircuitBreaker.CLOSED
    assert b.record_failure(key) == CircuitBreaker.CLOSED
    assert b.record_failure(key) == CircuitBreaker.CLOSED
    assert b.record_failure(key) == CircuitBreaker.OPEN   # threshold hit
    assert not b.allows(key) and not b.available(key)
    t[0] += 99.0
    assert not b.allows(key)                  # cooldown not elapsed
    t[0] += 2.0
    assert b.available(key)
    assert b.allows(key)                      # the half-open probe
    assert not b.allows(key)                  # one probe at a time
    assert b.record_failure(key) == CircuitBreaker.OPEN   # probe failed
    t[0] += 101.0
    assert b.allows(key)
    b.record_success(key)                     # probe succeeded: re-close
    assert b.state(key) == CircuitBreaker.CLOSED
    assert b.allows(key) and b.allows(key)    # closed: unlimited attempts
    snap = b.snapshot()[key]
    assert snap["opens"] == 2 and snap["failures"] == 4


@pytest.mark.parametrize("threshold,cooldown", [(1, 10.0), (3, 5.0)])
def test_breaker_sequences_are_the_reference(threshold, cooldown):
    """The same event sequence on a patched clock gives the same states,
    answers and snapshot in both packages."""
    mine, tm = _breaker(threshold, cooldown)
    ref, tr = _breaker(threshold, cooldown, rplan.CircuitBreaker)
    rng = np.random.default_rng(threshold)
    keys = ["a|powerof2|r1", "b|oddshape|r2"]
    for _ in range(200):
        key = keys[int(rng.integers(2))]
        op = ("allows", "available", "failure", "success",
              "state", "tick")[int(rng.integers(6))]
        if op == "tick":
            dt = float(rng.choice([0.5, 3.0, 11.0]))
            tm[0] += dt
            tr[0] += dt
            continue
        call = {"allows": "allows", "available": "available",
                "failure": "record_failure", "success": "record_success",
                "state": "state"}[op]
        assert getattr(mine, call)(key) == getattr(ref, call)(key)
    assert mine.snapshot() == ref.snapshot()


def test_breaker_success_resets_consecutive_count():
    b, _ = _breaker(threshold=3)
    for _ in range(2):
        b.record_failure("k")
    b.record_success("k")
    for _ in range(2):
        assert b.record_failure("k") == CircuitBreaker.CLOSED
    assert b.record_failure("k") == CircuitBreaker.OPEN


def test_breaker_lost_probe_reallowed_after_cooldown():
    b, t = _breaker(threshold=1, cooldown=10.0)
    b.record_failure("k")
    t[0] += 11.0
    assert b.allows("k")          # probe granted... and then its thread dies
    assert not b.allows("k")
    t[0] += 11.0
    assert b.allows("k")          # a lost probe can't wedge the pair


def test_breaker_threaded_hammer_exact_counts_and_single_probe():
    b, t = _breaker(threshold=5, cooldown=1000.0)
    n_threads, per_thread = 8, 50
    keys = [f"b{i}|powerof2|r1" for i in range(3)]

    def work(i):
        rng = np.random.default_rng(i)
        for j in range(per_thread):
            key = keys[int(rng.integers(len(keys)))]
            if j % 3 == 0:
                b.record_success(key)
            else:
                b.record_failure(key)
            b.allows(key)         # race state reads against transitions

    _hammer(n_threads, work)
    snap = b.snapshot()
    total = sum(e["failures"] + e["successes"] for e in snap.values())
    assert total == n_threads * per_thread    # no lost counts under racing
    # force every key open, advance past cooldown: exactly ONE probe each
    for key in keys:
        for _ in range(5):
            b.record_failure(key)
        assert b.state(key) == CircuitBreaker.OPEN
    t[0] += 1001.0
    grants = {key: [] for key in keys}
    lock = threading.Lock()

    def probe(i):
        for key in keys:
            ok = b.allows(key)
            with lock:
                grants[key].append(ok)

    _hammer(n_threads, probe)
    for key in keys:
        assert sum(grants[key]) == 1, f"{key}: {grants[key]}"


# ---------------------------------------------------------------------------
# planner fallback
# ---------------------------------------------------------------------------
def test_fallback_chain_ordering_and_terminal_xla():
    problem = Problem((64,), "Outplace_Complex", "float")
    chain = fallback_chain(problem)
    keys = [c.key() for c in chain]
    assert len(keys) == len(set(keys))            # deduped
    assert chain[0].backend == "dft"              # the tiny-1D estimate pin
    assert any(c.backend == "xla" and not c.axes for c in chain)
    # an oddshape rank-1 problem still terminates in a feasible candidate
    odd = fallback_chain(Problem((97,), "Outplace_Complex", "float"))
    assert any(c.backend == "xla" and not c.axes for c in odd)


CHAIN_PROBLEMS = [((64,), "Outplace_Complex", "float"),
                  ((4096,), "Outplace_Real", "double"),
                  ((3072,), "Inplace_Real", "float"),
                  ((97,), "Outplace_Complex", "float"),
                  ((6859,), "Inplace_Complex", "double"),
                  ((64, 64), "Outplace_Real", "float"),
                  ((48, 36), "Outplace_Complex", "double"),
                  ((19, 19), "Outplace_Real", "float"),
                  ((16, 16, 16), "Inplace_Real", "float"),
                  ((12, 10, 8), "Outplace_Complex", "double")]


@pytest.mark.parametrize("patient", [False, True])
@pytest.mark.parametrize("ext,kind,prec", CHAIN_PROBLEMS)
def test_fallback_chain_is_the_reference(ext, kind, prec, patient):
    """The reference's chain, minus the batch-tile knobs one block of the
    card cannot hold, which the port's candidate space leaves out
    (``tests/test_torch_planner.py``)."""
    problem = Problem(ext, kind, prec)
    mine = fallback_chain(problem, patient=patient)
    ref = rplan.fallback_chain(RProblem(ext, kind, prec), patient=patient)
    space = {c.key() for c in candidates(problem, patient=patient)}
    assert [c.key() for c in mine] == [c.key() for c in ref
                                       if c.key() in space]
    assert problem_class(Problem(ext, kind, prec)) == \
        rplan.problem_class(RProblem(ext, kind, prec))
    assert breaker_key("dft", Problem(ext, kind, prec)) == \
        rplan.breaker_key("dft", RProblem(ext, kind, prec))


def test_probe_finite_rejects_nan_executable():
    problem = Problem((8,), "Outplace_Complex", "float")
    probe_finite(lambda x: torch.ones_like(x), problem, CPU)   # finite
    probe_finite(lambda x: np.ones_like(x), problem, CPU)      # numpy too
    with pytest.raises(RuntimeError, match="finiteness probe failed"):
        probe_finite(lambda x: torch.full_like(x, float("nan")), problem,
                     CPU)


def test_make_plan_falls_back_past_injected_compile_errors(tmp_path):
    problem = Problem((64,), "Outplace_Complex", "float")
    wisdom = Wisdom(str(tmp_path / "w.json"), device_kind="cpu")
    breaker = CircuitBreaker(threshold=1, cooldown_s=3600.0)
    top = fallback_chain(problem)[0].backend
    fplan = FaultPlan([{"fault": "compile_error", "backend": top}])
    built = []

    def build(cand):
        built.append(cand.backend)
        return lambda x: x

    plan = make_plan(problem, PlanRigor.ESTIMATE,
                     build=faulty_build(build, fplan, problem),
                     wisdom=wisdom, breaker=breaker, device=CPU)
    assert plan.candidate.backend != top and plan.source == "fallback"
    assert any(top in key for key in plan.fallbacks)
    assert top not in built                   # the fault pre-empted its build
    # threshold=1: the failure opened the breaker and persisted a demotion
    assert breaker.state(breaker_key(top, problem)) == CircuitBreaker.OPEN
    assert top in wisdom.demoted(problem)
    # a fresh walk now skips the quarantined backend without re-building
    plan2 = make_plan(problem, PlanRigor.ESTIMATE,
                      build=faulty_build(build, fplan, problem),
                      wisdom=wisdom, breaker=breaker, device=CPU)
    assert plan2.candidate.backend != top
    # ...and so does a plain ESTIMATE call steered by wisdom alone
    plan3 = make_plan(problem, PlanRigor.ESTIMATE, wisdom=wisdom)
    assert plan3.candidate.backend != top


def test_make_plan_terminal_xla_survives_total_quarantine():
    problem = Problem((64,), "Outplace_Complex", "float")
    breaker = CircuitBreaker(threshold=1, cooldown_s=3600.0)

    def build(cand):
        if not (cand.backend == "xla" and not cand.axes):
            raise RuntimeError(f"{cand.backend} is down")
        return lambda x: x

    plan = make_plan(problem, PlanRigor.ESTIMATE, build=build,
                     breaker=breaker, device=CPU)
    assert plan.candidate.backend == "xla"
    assert len(plan.fallbacks) >= 1
    # everything failing -> the planner reports, not hangs
    breaker2 = CircuitBreaker(threshold=1, cooldown_s=3600.0)

    def all_down(cand):
        raise RuntimeError("device on fire")

    with pytest.raises(RuntimeError, match="no feasible plan"):
        make_plan(problem, PlanRigor.ESTIMATE, build=all_down,
                  breaker=breaker2, device=CPU)


def test_make_plan_probe_rejects_garbage_output():
    problem = Problem((16,), "Outplace_Complex", "float")
    breaker = CircuitBreaker(threshold=1, cooldown_s=3600.0)
    top = fallback_chain(problem)[0].backend

    def build(cand):
        fill = float("nan") if cand.backend == top else 0.0
        return lambda x: torch.full_like(x, fill)

    plan = make_plan(problem, PlanRigor.ESTIMATE, build=build,
                     breaker=breaker, probe=True, device=CPU)
    assert plan.candidate.backend != top      # NaN transform demoted


@pytest.mark.parametrize("device", [CPU, torch.device("cuda", 0), None],
                         ids=["cpu", "cuda0", "default"])
def test_make_plan_demotes_a_kernel_fault_only_on_the_cpu(tmp_path, device):
    """On the CPU a raising build demotes to the next candidate, as in the
    reference.  On a card (a CUDA ``device``, or none, which is cuda:0) a
    hand-written kernel's real build error raises, names the kernel and
    books neither the breaker nor wisdom: it is never returned as another
    backend's plan.  An injected fault demotes on both.  No device is
    touched: the build raises before any tensor is made."""
    problem = Problem((64,), "Outplace_Complex", "float")
    wisdom = Wisdom(str(tmp_path / "w.json"), device_kind="cpu")
    breaker = CircuitBreaker(threshold=1, cooldown_s=3600.0)
    top = fallback_chain(problem)[0].backend
    assert top != "xla"

    def build(cand):
        if cand.backend == top:
            raise RuntimeError("ptxas error: too many resources requested")
        return lambda x: x

    if device == CPU:
        plan = make_plan(problem, PlanRigor.ESTIMATE, build=build,
                         wisdom=wisdom, breaker=breaker, device=device)
        assert plan.candidate.backend != top and plan.source == "fallback"
        assert breaker.state(breaker_key(top, problem)) == CircuitBreaker.OPEN
        assert top in wisdom.demoted(problem)
        return
    with pytest.raises(KernelError, match=rf"kernel {top} .*ptxas error"):
        make_plan(problem, PlanRigor.ESTIMATE, build=build, wisdom=wisdom,
                  breaker=breaker, device=device)
    assert breaker.state(breaker_key(top, problem)) == CircuitBreaker.CLOSED
    assert not wisdom.demoted(problem)
    fplan = FaultPlan([{"fault": "compile_error", "backend": top}])
    plan = make_plan(problem, PlanRigor.ESTIMATE,
                     build=faulty_build(build, fplan, problem),
                     wisdom=wisdom, breaker=breaker, device=device)
    assert plan.candidate.backend != top and plan.source == "fallback"
    assert top in wisdom.demoted(problem)


# ---------------------------------------------------------------------------
# wisdom schema versioning + demotions
# ---------------------------------------------------------------------------
def test_wisdom_skips_corrupt_and_future_entries(tmp_path):
    path = tmp_path / "wisdom.json"
    problem = Problem((64,), "Outplace_Complex", "float")
    w = Wisdom(str(path), device_kind="cpu")
    w.record(problem, Candidate("xla"))
    w.save()
    with open(path) as f:
        store = json.load(f)
    good_key = next(iter(store))
    assert store[good_key]["v"] == WISDOM_SCHEMA_VERSION
    store["future"] = {"v": WISDOM_SCHEMA_VERSION + 1, "backend": "warp",
                       "options": []}
    store["not_a_record"] = "xla"
    store["bad_version"] = {"v": "two", "backend": "xla", "options": []}
    store["unparseable"] = {"v": 1, "backend": "xla", "options": [["k"]]}
    store["__demoted__"] = {"cpu|powerof2|r1": "stockham"}   # not a list
    with open(path, "w") as f:
        json.dump(store, f)
    with pytest.warns(UserWarning) as warned:
        fresh = Wisdom(str(path), device_kind="cpu")
    assert len(warned) == 5
    msgs = "\n".join(str(x.message) for x in warned)
    assert "newer than this reader" in msgs
    assert "malformed demotion table" in msgs
    assert fresh.lookup(problem) is not None      # valid entry survives
    assert len(fresh) == 1
    import warnings as _w
    with _w.catch_warnings():
        _w.simplefilter("ignore")
        fresh.save()
    reread = Wisdom(str(path), device_kind="cpu")
    assert reread.lookup(problem).backend == "xla"


def test_wisdom_legacy_v1_records_still_load(tmp_path):
    path = tmp_path / "wisdom.json"
    with open(path, "w") as f:                    # pre-versioning layout
        json.dump({"cpu|64-f-oc-b1": {"backend": "xla", "options": []}}, f)
    w = Wisdom(str(path), device_kind="cpu")
    assert len(w) == 1


def test_wisdom_demotions_roundtrip_and_union_merge(tmp_path):
    path = tmp_path / "wisdom.json"
    p1 = Problem((64,), "Outplace_Complex", "float")
    p2 = Problem((64, 64), "Outplace_Complex", "float")
    assert problem_class(p1) != problem_class(p2)
    w1 = Wisdom(str(path), device_kind="cpu")
    w2 = Wisdom(str(path), device_kind="cpu")
    w1.record_demotion(p1, "stockham")
    w2.record_demotion(p2, "fourstep_pallas")
    w1.save()
    w2.save()          # merge-on-save must union, not clobber, w1's table
    fresh = Wisdom(str(path), device_kind="cpu")
    assert fresh.demoted(p1) == {"stockham"}
    assert fresh.demoted(p2) == {"fourstep_pallas"}
    assert fresh.demoted(Problem((97,), "Outplace_Complex", "float")) \
        == frozenset()
    # demotions are bookkeeping, not selections: store length ignores them
    assert len(fresh) == 0


# ---------------------------------------------------------------------------
# chaos traffic specs
# ---------------------------------------------------------------------------
def test_traffic_spec_faults_roundtrip():
    spec = TrafficSpec(extents=((64,),), requests=4,
                       faults=({"fault": "compile_error",
                                "backend": "stockham_pallas"},))
    assert TrafficSpec.from_dict(spec.to_dict()) == spec
    assert spec.fault_plan().rules[0].backend == "stockham_pallas"
    assert "faults" not in TrafficSpec(extents=((64,),)).to_dict()
    with pytest.raises(ValueError, match="unknown fault"):
        TrafficSpec(extents=((64,),), faults=({"fault": "meteor"},))
