"""The port's planner against the reference package's.

* ``candidates()``, with PATIENT off and on, lists the reference's
  candidates (every backend of the reference's single-device planner,
  ``sixstep``, ``chirpz_pallas`` and ``bluestein`` included) minus the
  batch-tile knobs one block cannot hold (listed here);
  ``estimate_bytes_moved``, ``estimate_choice`` and ``fallback_chain``
  agree with the reference's; over the caps the port picks what it can
  run;
* the cost-model tables and wisdom files read the same in both packages
  (per-axis ``nd[...]`` records, demotions, nearest-neighbor lookups);
* ``TorchPlanned`` under a fixed candidate (the dft pin, an ``nd[...]``
  plan from wisdom) gives the reference's forward, MEASURE on the CPU
  picks the fastest of its own timings and writes v3 wisdom, WISDOM_ONLY
  runs all the committed CPU wisdom file's records through their recorded
  plans (``bluestein`` included), and a miss is fftw's NULL plan.

The reference's MEASURE never runs here (it would compile every
candidate): lists, estimates, picks, and forwards under a fixed candidate
are compared.  Forward tolerance: rel-L2 1e-5 (float) and 1e-12 (double),
the same algorithm and tables, only the summation order differs.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from helpers.accuracy import rand_input, rel_l2

from repro.core import candidates as rc
from repro.core import costmodel as rcm
from repro.core import plan as rplan
from repro.core.client import Problem as RProblem
from repro.core.clients import jax_fft
from repro.core.wisdom import Wisdom as RWisdom
from repro_torch.core import candidates as pc
from repro_torch.core import costmodel as pcm
from repro_torch.core import plan as pplan
from repro_torch.core.client import KINDS, Problem, TorchContext
from repro_torch.core.clients.torch_fft import (TorchFourStepPallas,
                                                TorchPlanned,
                                                TorchStockhamPallas)
from repro_torch.core.plan import PlanCache, PlanRigor
from repro_torch.core.suite import Session, SuiteSpec
from repro_torch.core.tree import BenchNode
from repro_torch.core.wisdom import Wisdom

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINES = os.path.join(ROOT, "benchmarks", "baselines")
TOL = {"float": 1e-5, "double": 1e-12}

#: The planner's problems (``chip_smoke.py``'s P1-P15) with their batches.
PROBLEMS = {
    "P1": ((256, 256, 256), "Outplace_Real", "float", 1),
    "P2": ((128, 128, 128), "Inplace_Complex", "double", 1),
    "P3": ((4096,), "Outplace_Complex", "float", 16384),
    "P4": ((3072, 3072), "Outplace_Real", "float", 1),
    "P5": ((945,), "Inplace_Real", "float", 65536),
    "P6": ((128, 128), "Outplace_Real", "float", 8192),
    "P7": ((64, 64), "Inplace_Complex", "double", 8192),
    "P8": ((128,), "Outplace_Complex", "float", 524288),
    "P9": ((100,), "Inplace_Real", "double", 655360),
    "P10": ((1 << 22,), "Outplace_Complex", "float", 16),
    "P11": ((1 << 24,), "Inplace_Complex", "double", 2),
    "P12": ((19 ** 4,), "Outplace_Complex", "float", 512),
    "P13": ((19 ** 3,), "Inplace_Real", "double", 8192),
    "P14": ((361, 361), "Outplace_Real", "float", 1024),
    "P15": ((19,), "Outplace_Complex", "float", 3532045),
}
#: The reference's ESTIMATE picks there (``chip_smoke.ESTIMATE_PICKS``).
ESTIMATE_PICKS = {"P1": "xla", "P2": "xla", "P3": "fourstep_pallas",
                  "P4": "xla", "P5": "fourstep_pallas", "P6": "fft2_pallas",
                  "P7": "fft2_pallas", "P8": "dft", "P9": "dft",
                  "P10": "xla", "P11": "xla", "P12": "xla",
                  "P13": "chirpz_pallas", "P14": "fourstep_pallas",
                  "P15": "dft"}

#: Rank 1-3 extents (P1-P9's among them), with every kind and precision.
GRID = ((1,), (2,), (12,), (16,), (97,), (100,), (128,), (945,), (4096,),
        (1, 8), (16, 1), (7, 9), (8, 12), (64, 64), (60, 100), (128, 128),
        (3072, 3072), (2, 3, 5), (4, 4, 8), (128, 128, 128),
        (256, 256, 256))
_FFT2_KNOBS = {"fft2_pallas", "fft2_pallas(radix=4,tile_b=2)",
               "fft2_pallas(radix=8,tile_b=2)", "fft2_pallas(radix=4,tile_b=8)",
               "fft2_pallas(radix=8,tile_b=8)"}
#: What the port refuses on the grid at batch 1: the fused rank-2 kernel
#: holds 8192 complex64 / 4096 complex128 points in one block (128x128
#: complex, or packed 128x64 in double, is over) and runs larger tiles as
#: passes, which take no batch tile; at 3072x3072 a block holds only a few
#: 3072- or 1536-point rows for the knobs' batch tiles.  The chirp-Z
#: batch tile of 16 runs the Stockham kernel at the padded length m: a
#: block does not hold 16 rows of m = 6144 (3072x3072) or m = 512
#: complex128 (256^3), and m = 8192 complex128 (4096, complex) runs as two
#: column passes, which take no batch tile.
_FFT2_TILES = _FFT2_KNOBS - {"fft2_pallas"}
_CHIRPZ_TILE = "chirpz_pallas(tile_b=16)"
CAPPED = {
    ((128, 128), "complex", "float"): _FFT2_TILES,
    ((128, 128), "complex", "double"): _FFT2_TILES,
    ((128, 128), "real", "double"): _FFT2_TILES,
    ((3072, 3072), "any", "float"): {
        "fourstep_pallas(tile_b=16)",
        "stockham_pallas(radix=4,tile_b=16)",
        "stockham_pallas(radix=8,tile_b=16)", _CHIRPZ_TILE},
    ((3072, 3072), "any", "double"): {
        "fourstep_pallas(tile_b=8)",
        "fourstep_pallas(tile_b=16)", "stockham_pallas(radix=4,tile_b=4)",
        "stockham_pallas(radix=8,tile_b=4)",
        "stockham_pallas(radix=4,tile_b=16)",
        "stockham_pallas(radix=8,tile_b=16)", _CHIRPZ_TILE},
    ((4096,), "complex", "double"): {_CHIRPZ_TILE},
    ((256, 256, 256), "any", "double"): {_CHIRPZ_TILE},
}
#: Where the fused rank-2 kernel runs as passes on the grid (the tiles
#: above): ESTIMATE prices it at one round trip a pass, so its estimate is
#: the reference's times ``fft2_passes`` and its pick may differ.
MULTI_PASS = {key for key in CAPPED if key[0] == (128, 128)}


def _capped(ext, kind, precision) -> set:
    kclass = "complex" if kind.endswith("Complex") else "real"
    return (CAPPED.get((ext, kclass, precision), set())
            | CAPPED.get((ext, "any", precision), set()))


def _ref_cand(cand):
    return rc.Candidate(cand.backend, cand.options,
                        tuple(_ref_cand(a) for a in cand.axes), cand.mesh)


@pytest.mark.parametrize("ext", GRID, ids=lambda e: "x".join(map(str, e)))
def test_candidates_estimates_and_picks_match_reference(ext):
    for kind in KINDS:
        for precision in ("float", "double"):
            rp, pp = RProblem(ext, kind, precision), Problem(ext, kind, precision)
            capped = _capped(ext, kind, precision)
            for patient in (False, True):
                want = [c.key() for c in rc.candidates(rp, patient)
                        if c.key() not in capped]
                got = [c.key() for c in pc.candidates(pp, patient)]
                assert got == want, (ext, kind, precision, patient)
            kclass = "complex" if kind.endswith("Complex") else "real"
            multi = (ext, kclass, precision) in MULTI_PASS
            for cand in pc.candidates(pp, patient=True):
                want = rcm.estimate_bytes_moved(rp, _ref_cand(cand))
                if cand.backend == "fft2_pallas":
                    want *= pc.fft2_passes(pp)
                assert pcm.estimate_bytes_moved(pp, cand) == want, cand.key()
            ref_pick = rcm.estimate_choice(rp)
            pick = pcm.estimate_choice(pp)
            if not capped:
                ref_chain = [c.key() for c in rplan.fallback_chain(rp)]
                assert [c.key() for c in pplan.fallback_chain(pp)] == ref_chain
            if not multi and ref_pick.key() not in capped:
                assert pick.key() == ref_pick.key(), (ext, kind, precision)
            assert pcm.estimate_bytes_moved(pp, pick) < float("inf")


def test_estimate_picks_on_the_planner_problems():
    """P1-P15 at their batches: the reference's picks, as ``chip_smoke.py``
    hardcodes them."""
    for name, (ext, kind, precision, batch) in PROBLEMS.items():
        ref = rcm.estimate_choice(RProblem(ext, kind, precision, batch)).key()
        got = pcm.estimate_choice(Problem(ext, kind, precision, batch)).key()
        assert got == ref == ESTIMATE_PICKS[name], name


@pytest.mark.parametrize("ext,kind,precision", [
    ((1 << 21,), "Outplace_Complex", "float"),
    ((32768,), "Inplace_Complex", "double"),
    ((14407,), "Outplace_Complex", "float"),
    ((1024, 512), "Outplace_Complex", "float"),
    ((1024, 1024), "Outplace_Real", "double"),
    ((131, 64), "Outplace_Complex", "float"),
])
def test_over_the_caps_the_port_picks_what_it_can_run(ext, kind, precision):
    problem = Problem(ext, kind, precision)
    pick = pcm.estimate_choice(problem)
    backends = [a.backend for a in pick.per_axis(problem.rank)]
    assert all(b in pc.BACKENDS for b in backends)
    if pick.backend not in pc.FUSED_ND:
        assert all(pc.axis_feasible(b, pc.axis_engine_n(problem, i), precision)
                   for i, b in enumerate(backends))
    assert pc.backend_supports(pick.backend, problem) or pick.axes
    assert pcm.estimate_bytes_moved(problem, pick) < float("inf")


def test_cost_tables_read_the_same_in_both_packages(tmp_path):
    assert pcm.DEFAULT_COEFFICIENTS.to_dict() == rcm.DEFAULT_COEFFICIENTS.to_dict()
    path = os.path.join(BASELINES, "costmodel_cpu.json")
    port, ref = pcm.load_tables(path), rcm.load_tables(path)
    assert set(port) == set(ref) == {"cpu"}
    assert port["cpu"].coeffs.to_dict() == ref["cpu"].coeffs.to_dict()
    assert pcm.model_for_device("cpu", path).device_kind == "cpu"
    assert pcm.model_for_device("NVIDIA H100 80GB HBM3", path) \
        is pcm.DEFAULT_MODEL
    out = str(tmp_path / "t.json")
    pcm.save_tables(out, port, meta={"generated_by": "test"})
    assert rcm.load_tables(out)["cpu"].coeffs.to_dict() == \
        ref["cpu"].coeffs.to_dict()


def test_session_installs_a_cost_table(tmp_path):
    """``SuiteSpec.costmodel`` makes a table the active model for the run:
    ESTIMATE re-ranks as the reference's does under the same table."""
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump({"schema": 1, "tables": {"cpu": {
            "xla_smooth_passes": 100.0}}}, f)
    problem = Problem((8, 16), "Outplace_Complex", "float")
    with rcm.use_model(rcm.model_for_device("cpu", path)):
        want = rcm.estimate_choice(RProblem((8, 16), "Outplace_Complex")).key()
    assert want != "xla"
    session = Session(TorchContext("cpu"))
    rs = session.run(SuiteSpec(costmodel=path, output=None, repetitions=1),
                     nodes=[BenchNode(TorchPlanned, problem)])
    assert not rs.failures()
    assert _plan(session, problem, PlanRigor.ESTIMATE).candidate.key() == want
    assert pcm.get_active_model() is pcm.DEFAULT_MODEL   # restored


def _records():
    """Selections of each shape: knobs, a per-axis plan, the fallback."""
    return [
        ((1024,), "Outplace_Complex", "float",
         "stockham_pallas(radix=4,tile_b=16)"),
        ((64, 48), "Outplace_Real", "float", "nd[dft;fourstep_pallas]"),
        ((16, 24), "Inplace_Complex", "double",
         "nd[fourstep_pallas(tile_b=8);stockham_pallas]"),
        ((945,), "Inplace_Real", "float", "fourstep_pallas(tile_b=4)"),
        ((8, 8, 8), "Outplace_Complex", "double", "xla"),
    ]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_wisdom_files_read_the_same_in_both_packages(writer, tmp_path):
    path = str(tmp_path / "wisdom.json")
    make = (lambda: RWisdom(path, device_kind="cpu")) if writer == "reference" \
        else (lambda: Wisdom(path, device_kind="cpu"))
    cand_of = (lambda k: _ref_cand(pc.Candidate.from_key(k))) \
        if writer == "reference" else pc.Candidate.from_key
    prob_of = RProblem if writer == "reference" else Problem
    w = make()
    for i, (ext, kind, precision, key) in enumerate(_records()):
        w.record(prob_of(ext, kind, precision), cand_of(key),
                 measured_ms=0.5 + i, rigor="measure")
    w.record(prob_of((1024,), "Outplace_Complex", "float"),
             cand_of("stockham_pallas(tile_b=4)"), scope="stockham_pallas")
    w.record_demotion(prob_of((100,), "Outplace_Complex", "float"), "dft")
    w.save()
    port, ref = Wisdom(path, device_kind="cpu"), RWisdom(path, device_kind="cpu")
    assert len(port) == len(ref) == len(_records()) + 1
    for ext, kind, precision, key in _records():
        got = port.lookup(Problem(ext, kind, precision))
        want = ref.lookup(RProblem(ext, kind, precision))
        assert got.key() == want.key() == key
        assert [a.key() for a in got.axes] == [a.key() for a in want.axes]
    assert port.lookup(Problem((1024,), "Outplace_Complex"),
                       scope="stockham_pallas").key() == \
        "stockham_pallas(tile_b=4)"
    assert port.demoted(Problem((100,), "Outplace_Complex")) == \
        ref.demoted(RProblem((100,), "Outplace_Complex")) == {"dft"}
    for ext, kind, precision in (((2048,), "Outplace_Complex", "float"),
                                 ((64, 96), "Outplace_Real", "float"),
                                 ((945 * 3,), "Inplace_Real", "float")):
        got = port.lookup_near(Problem(ext, kind, precision))
        want = ref.lookup_near(RProblem(ext, kind, precision))
        assert (got is None) == (want is None), ext
        if got is not None:
            assert (got[0].key(), got[1]) == (want[0].key(), want[1]), ext
    assert port.lookup_near(Problem((2048,), "Outplace_Complex"))[0].key() == \
        "stockham_pallas(radix=4,tile_b=16)"
    # a port save keeps every record and provenance field the file had
    before = json.loads(open(path).read())
    port.save()
    assert json.loads(open(path).read()) == before


def _plan(session, problem, rigor, scope="*"):
    plan, event = session.plan_cache.plan(
        PlanCache.plan_key(session.device_kind, problem, rigor, scope),
        lambda: None)
    assert event == "hit" and plan is not None
    return plan


def _forward_of(problem, context, rigor, wisdom=None, cls=TorchPlanned):
    x = rand_input(problem, seed=13)
    client = cls(problem, context, rigor=rigor, wisdom=wisdom)
    client.allocate()
    client.init_forward()
    client.upload(x)
    client.execute_forward()
    return x, client._spec.numpy(), client


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("kind", KINDS)
def test_planned_dft_pin_matches_reference_forward(kind, precision):
    problem = Problem((100,), kind, precision, batch=3)
    cpu = TorchContext("cpu")
    x, got, client = _forward_of(problem, cpu, PlanRigor.ESTIMATE)
    assert client.plan.candidate.key() == "dft"
    assert client.plan_source == "estimate"
    ref_problem = RProblem((100,), kind, precision, 3)
    assert rcm.estimate_choice(ref_problem).key() == "dft"
    want = np.asarray(jax_fft._forward_fn(ref_problem,
                                          rc.Candidate("dft"))(x))
    assert got.shape == want.shape
    assert rel_l2(got, want) <= TOL[precision]
    # the FFT body's table of the engine length's roots (100, or the
    # packed 50), and for a real kind the pack roots
    itemsize = 8 if precision == "float" else 16
    complex_kind = kind.endswith("Complex")
    assert client.get_plan_size() == (100 if complex_kind else 50) * \
        itemsize + (0 if complex_kind else 50 * itemsize)


@pytest.mark.parametrize("key", ["nd[dft;fourstep_pallas]",
                                 "nd[fourstep_pallas;dft]",
                                 "nd[dft;stockham_pallas(radix=4,tile_b=1)]"])
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("kind", ["Outplace_Real", "Inplace_Complex"])
def test_planned_nd_plan_from_wisdom_matches_reference(kind, precision, key,
                                                       tmp_path):
    """A per-axis plan recorded in wisdom runs through ``TorchPlanned``
    under WISDOM_ONLY and gives the reference's forward under that plan
    (the reference's complex128 Stockham kernel in interpret mode is
    exact only at tile 1, ROADMAP.md queue 3)."""
    ext = (16, 24)
    problem = Problem(ext, kind, precision, batch=2)
    wisdom = Wisdom(str(tmp_path / "w.json"), device_kind="cpu")
    cand = pc.Candidate.from_key(key)
    wisdom.record(problem, cand)
    x, got, client = _forward_of(problem, TorchContext("cpu"),
                                 PlanRigor.WISDOM_ONLY, wisdom)
    assert client.plan.candidate == cand and client.plan_source == "wisdom"
    want = np.asarray(jax_fft._forward_fn(RProblem(ext, kind, precision, 2),
                                          _ref_cand(cand))(x))
    assert got.shape == want.shape
    assert rel_l2(got, want) <= TOL[precision]


def test_measure_on_cpu_picks_its_fastest_and_writes_v3_wisdom(tmp_path):
    path = str(tmp_path / "wisdom.json")
    problems = [Problem((64,), "Outplace_Complex"),
                Problem((8, 16), "Outplace_Real", "double")]
    session = Session(TorchContext("cpu"))
    rs = session.run(SuiteSpec(rigor="measure", wisdom=path, output=None,
                               warmups=0, repetitions=1),
                     nodes=[BenchNode(TorchPlanned, p) for p in problems])
    assert not rs.failures(), [r.error for r in rs.failures()]
    assert {r.plan_source for r in rs.rows if r.library == "TorchPlanned"
            and r.op != "validate"} == {"measure"}
    store = json.loads(open(path).read())
    for p in problems:
        plan = _plan(session, p, PlanRigor.MEASURE)
        assert set(plan.measured_ms) == {c.key() for c in pc.candidates(p)}
        assert all(np.isfinite(list(plan.measured_ms.values())))
        best = min(plan.measured_ms, key=plan.measured_ms.get)
        assert plan.candidate.key() == best and plan.source == "measure"
        rec = store[f"cpu|{p.signature()}"]
        assert rec["v"] == 3 and rec["rigor"] == "measure"
        assert rec["measured_ms"] == plan.measured_ms[best]
        assert RWisdom(path, device_kind="cpu").lookup(
            RProblem(p.extents, p.kind, p.precision)).key() == best
    # a second session plans from the file, with no sweep
    again = Session(TorchContext("cpu"))
    rs = again.run(SuiteSpec(rigor="measure", wisdom=path, output=None,
                             warmups=0, repetitions=1),
                   nodes=[BenchNode(TorchPlanned, problems[0])])
    assert _plan(again, problems[0], PlanRigor.MEASURE).source == "wisdom"


def test_pinned_clients_sweep_only_their_own_knobs(tmp_path):
    """PATIENT on a pinned client times only its backend's knobs and
    records the winner under the backend's scope."""
    path = str(tmp_path / "wisdom.json")
    problem = Problem((64,), "Outplace_Complex", batch=4)
    session = Session(TorchContext("cpu"))
    for cls in (TorchStockhamPallas, TorchFourStepPallas):
        rs = session.run(SuiteSpec(rigor="patient", wisdom=path, output=None,
                                   warmups=0, repetitions=1),
                         nodes=[BenchNode(cls, problem)])
        assert not rs.failures()
        plan = _plan(session, problem, PlanRigor.PATIENT,
                     scope=cls.backend_filter)
        assert len(plan.measured_ms) > 1
        assert all(k.startswith(cls.backend_filter) for k in plan.measured_ms)
        rec = RWisdom(path, device_kind="cpu").lookup(
            RProblem((64,), "Outplace_Complex", batch=4),
            scope=cls.backend_filter)
        assert rec.key() == plan.candidate.key()
    assert RWisdom(path, device_kind="cpu").lookup(
        RProblem((64,), "Outplace_Complex", batch=4)) is None


def test_wisdom_only_runs_the_committed_cpu_wisdom(tmp_path):
    """Every record of ``benchmarks/baselines/wisdom_cpu.json`` runs through
    its recorded plan, the one naming ``bluestein`` (384/Outplace_Real)
    included: no node fails."""
    path = str(tmp_path / "wisdom_cpu.json")
    shutil.copy(os.path.join(BASELINES, "wisdom_cpu.json"), path)
    wisdom = Wisdom(path, device_kind="cpu")
    problems = [wisdom._parse_key(k) for k in json.loads(open(path).read())]
    assert len(problems) == 26 and None not in problems
    session = Session(TorchContext("cpu"))
    rs = session.run(SuiteSpec(rigor="wisdom_only", wisdom=path, output=None,
                               warmups=0, repetitions=1),
                     nodes=[BenchNode(TorchPlanned, p) for p in problems])
    assert not rs.failures(), [(r.extents, r.error) for r in rs.failures()]
    assert len([r for r in rs.query(op="validate") if r.success]) == 26
    ref = RWisdom(path, device_kind="cpu")
    picks = set()
    for p in problems:
        plan = _plan(session, p, PlanRigor.WISDOM_ONLY)
        assert plan.source == "wisdom"
        assert plan.candidate.key() == ref.lookup(
            RProblem(p.extents, p.kind, p.precision, p.batch)).key()
        picks.add(plan.candidate.key())
    assert "bluestein" in picks
    assert {r.plan_source for r in rs.rows if r.library == "TorchPlanned"
            and r.op != "validate"} == {"wisdom"}


def test_wisdom_miss_is_a_null_plan(tmp_path):
    path = str(tmp_path / "empty.json")
    nodes = [BenchNode(TorchPlanned, Problem((16,), "Outplace_Complex")),
             BenchNode(TorchStockhamPallas, Problem((16,), "Outplace_Complex"))]
    rs = Session(TorchContext("cpu")).run(
        SuiteSpec(rigor="wisdom_only", wisdom=path, output=None, warmups=0,
                  repetitions=1), nodes=nodes)
    fails = rs.failures()
    assert len(fails) == 2 and not rs.query(op="execute_forward")
    assert all("NULL plan (wisdom miss)" in r.error for r in fails)
    assert not os.path.exists(path)      # WISDOM_ONLY never writes


@pytest.mark.parametrize("key", ["sixstep(split_n1=8)", "chirpz_pallas",
                                 "nd[dft;bluestein]"])
def test_a_backend_the_port_lacks_is_a_failed_node(key, tmp_path):
    """The reference's last three backends, which the port lacked before
    its large-N slice (a plan naming one was a failed node): a wisdom
    record of each builds, runs through ``Session.run`` on the CPU and
    gives the reference's forward under the same plan."""
    problem = Problem((16, 64), "Outplace_Complex")
    wisdom = Wisdom(str(tmp_path / "w.json"), device_kind="cpu")
    cand = pc.Candidate.from_key(key)
    wisdom.record(problem, cand)
    rs = Session(TorchContext("cpu"), wisdom=wisdom).run(
        SuiteSpec(rigor="wisdom_only", output=None, warmups=0, repetitions=1),
        nodes=[BenchNode(TorchPlanned, problem)])
    assert not rs.failures(), [r.error for r in rs.failures()]
    assert rs.query(op="execute_forward")
    x, got, client = _forward_of(problem, TorchContext("cpu"),
                                 PlanRigor.WISDOM_ONLY, wisdom)
    assert client.plan.candidate == cand and client.plan_source == "wisdom"
    want = np.asarray(jax_fft._forward_fn(RProblem((16, 64),
                                                   "Outplace_Complex"),
                                          _ref_cand(cand))(x))
    assert got.shape == want.shape
    assert rel_l2(got, want) <= TOL["float"]


def test_demotion_steers_estimate_as_in_the_reference(tmp_path):
    """A wisdom-demoted ESTIMATE pick gives way to the next candidate of
    the fallback chain, in both packages."""
    rpath, ppath = str(tmp_path / "r.json"), str(tmp_path / "p.json")
    rw, pw = RWisdom(rpath, "cpu"), Wisdom(ppath, "cpu")
    rp, pp = RProblem((100,), "Outplace_Complex"), Problem((100,), "Outplace_Complex")
    rw.record_demotion(rp, "dft")
    pw.record_demotion(pp, "dft")
    want = rplan.make_plan(rp, rplan.PlanRigor.ESTIMATE, wisdom=rw)
    got = pplan.make_plan(pp, PlanRigor.ESTIMATE, wisdom=pw)
    assert got.candidate.key() == want.candidate.key() != "dft"


def test_session_device_kind_and_spec_rigor():
    assert Session(TorchContext("cpu")).device_kind == "cpu"
    assert SuiteSpec(rigor=PlanRigor.PATIENT).rigor == "patient"
    assert SuiteSpec(rigor="measure").benchmark_config().rigor is \
        PlanRigor.MEASURE
    with pytest.raises(ValueError, match="unknown rigor"):
        SuiteSpec(rigor="exhaustive")
    assert torch.device("cuda", 0) == TorchContext().device


def _planted_build(cand):
    """A build whose dft kernel fails; every other candidate is the
    identity."""
    if cand.backend == "dft":
        raise RuntimeError("dft_matmul: planted build failure (dft.cu)")
    return lambda x: x


def test_measure_records_a_raising_candidate_as_nan_only_on_the_cpu():
    """On the CPU every candidate runs its plain version, and one that
    raises is NaN, as in the reference; on another device the raise is a
    kernel failure and propagates: no other candidate takes its place."""
    problem = Problem((100,), "Outplace_Complex", batch=2)
    cands = pc.candidates(problem)
    assert "dft" in [c.key() for c in cands] and cands[0].key() == "xla"
    pick, timings = pplan.measure_plan(problem, _planted_build, cands, "cpu")
    assert np.isnan(timings["dft"]) and pick.key() != "dft"
    assert all(np.isfinite(t) for k, t in timings.items() if k != "dft")
    with pytest.raises(RuntimeError, match="planted build failure"):
        pplan.measure_plan(problem, _planted_build, cands, "meta")


def test_a_kernel_that_fails_under_measure_is_a_failed_node(monkeypatch,
                                                            tmp_path):
    """``TorchPlanned`` under MEASURE on a device other than the CPU: a
    candidate's kernel that fails to build fails the node with its error,
    and no pick is written to wisdom."""
    from repro_torch.core.clients import torch_fft

    class OffCpuPlanned(TorchPlanned):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.device = torch.device("meta")

    monkeypatch.setattr(torch_fft, "_forward_fn",
                        lambda problem, cand, device: torch_fft.Transform(
                            _planted_build(cand)))
    path = str(tmp_path / "w.json")
    rs = Session(TorchContext("cpu")).run(
        SuiteSpec(rigor="measure", wisdom=path, output=None, warmups=0,
                  repetitions=1),
        nodes=[BenchNode(OffCpuPlanned, Problem((100,), "Outplace_Complex"))])
    (row,) = rs.failures()
    assert row.op == "validate" and "planted build failure" in row.error
    assert not rs.query(op="execute_forward")
    assert not Wisdom(path, device_kind="cpu").lookup(
        Problem((100,), "Outplace_Complex"))
