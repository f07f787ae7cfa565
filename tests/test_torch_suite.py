"""The port's serializable suite spec (``repro_torch.core.suite``) against
the reference package's ``repro.core.suite``.

* ``SweepSpec`` expansions and their errors are the reference's;
* ``SuiteSpec``'s dict, JSON and TOML text is the reference's once the
  client titles are mapped, and a spec file written by either package is
  read by the other (the reference's ``examples/suite.toml`` too);
* ``ResultSet``'s summary, concat and save, ``Session.run`` streaming and
  selection, and ``support_matrix`` follow the reference; every supported
  cell of the matrix runs its CPU forward within the suite's bar;
* ``make_plan(near=False)`` sweeps where ``near=True`` takes the
  neighbor's wisdom pick.
"""

import csv
import dataclasses
import json
import os
import tomllib

import numpy as np
import pytest
import torch

from helpers.accuracy import assert_rel_l2, numpy_forward, rand_input
from repro.core import suite as rsuite
from repro.core.candidates import BACKENDS as REF_BACKENDS
from repro.core.results import columns_for as ref_columns_for
from repro_torch.core import extents as pext
from repro_torch.core.candidates import Candidate
from repro_torch.core.client import Problem, TorchContext
from repro_torch.core.clients.torch_fft import _forward_fn
from repro_torch.core.plan import PlanCacheStats, PlanRigor, make_plan
from repro_torch.core.results import COLUMNS, columns_for, rows_to_csv
from repro_torch.core.suite import (SUPPORT_PROBE_EXTENTS, ResultSet, Session,
                                    SuiteSpec, SweepSpec, support_matrix)
from repro_torch.core.wisdom import Wisdom
from test_torch_tables import TITLES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = TorchContext("cpu")


def _port_of(ref_spec) -> SuiteSpec:
    """The reference spec's plain data with the port's client titles."""
    d = ref_spec.to_dict()
    d["clients"] = [TITLES[c] for c in d["clients"]]
    return SuiteSpec.from_dict(d)


# --------------------------------------------------------------------------
# sweeps
# --------------------------------------------------------------------------
SWEEPS = [
    dict(extent_class="powerof2", rank=r, min_exp=lo, max_exp=hi)
    for r in (1, 2, 3) for lo, hi in ((0, 3), (3, 5), (10, 12))
] + [
    dict(extent_class="radix357", rank=r, **kw)
    for r in (1, 2, 3) for kw in ({}, {"count": 4}, {"count": 5, "start": 96},
                                  {"start": 1000}, {"count": 0})
] + [
    dict(extent_class="oddshape", rank=r, **kw)
    for r in (1, 2, 3) for kw in ({}, {"count": 1}, {"count": 8})
]


@pytest.mark.parametrize("kw", SWEEPS, ids=lambda kw: "-".join(
    f"{v}" for v in kw.values()))
def test_sweep_expansions_are_the_reference(kw):
    port, ref = SweepSpec(**kw), rsuite.SweepSpec(**kw)
    assert port.extents() == ref.extents()
    assert port.to_dict() == ref.to_dict()
    assert SweepSpec.from_dict(ref.to_dict()) == port


BAD_SWEEPS = [
    dict(extent_class="fibonacci"),
    dict(extent_class="powerof2", min_exp=3),
    dict(extent_class="powerof2", rank=0, min_exp=3, max_exp=4),
    dict(extent_class="powerof2", rank=4, min_exp=3, max_exp=4),
    dict(extent_class="radix357", min_exp=3),
    dict(extent_class="oddshape", start=19),
]


@pytest.mark.parametrize("kw", BAD_SWEEPS)
def test_bad_sweeps_raise_the_reference_error(kw):
    with pytest.raises(ValueError) as ref:
        rsuite.SweepSpec(**kw)
    with pytest.raises(ValueError) as port:
        SweepSpec(**kw)
    assert str(port.value) == str(ref.value)


def test_generators_are_the_reference():
    from repro.core import extents as rext
    assert pext.SWEEP_CLASSES == rext.SWEEP_CLASSES
    assert pext._SWEEP_PARAMS == rext._SWEEP_PARAMS


# --------------------------------------------------------------------------
# the spec and its text
# --------------------------------------------------------------------------
REF_FULL = rsuite.SuiteSpec(
    clients=("XlaFFT", "Stockham"), load=("benchmarks.table_kernels",),
    extents=("64", "32x32"),
    sweeps=(rsuite.SweepSpec("powerof2", rank=3, min_exp=3, max_exp=5),
            rsuite.SweepSpec("radix357", rank=1, count=4, start=96)),
    kinds=("Outplace_Real", "Inplace_Complex"), precisions=("float",),
    batch=2, select="*/float/*/Outplace_Real", rigor="measure",
    warmups=2, repetitions=4, error_bound=1e-4, seed=7,
    plan_cache=False, wisdom="w.json", costmodel="c.json",
    output="out.jsonl", format="jsonl", verbose=True)
PORT_FULL = SuiteSpec(
    clients=("TorchFFT", "TorchStockham"), load=("benchmarks.table_kernels",),
    extents=("64", "32x32"),
    sweeps=(SweepSpec("powerof2", rank=3, min_exp=3, max_exp=5),
            SweepSpec("radix357", rank=1, count=4, start=96)),
    kinds=("Outplace_Real", "Inplace_Complex"), precisions=("float",),
    batch=2, select="*/float/*/Outplace_Real", rigor="measure",
    warmups=2, repetitions=4, error_bound=1e-4, seed=7,
    plan_cache=False, wisdom="w.json", costmodel="c.json",
    output="out.jsonl", format="jsonl", verbose=True)


def _mapped(text: str) -> str:
    for ref, port in TITLES.items():
        text = text.replace(f'"{ref}"', f'"{port}"')
    return text


@pytest.mark.parametrize("which", ["full", "defaults", "sweeps_only"])
def test_spec_text_is_the_reference(which):
    ref, port = {
        "full": (REF_FULL, PORT_FULL),
        "defaults": (rsuite.SuiteSpec(extents=("16",)),
                     SuiteSpec(extents=("16",))),
        "sweeps_only": (
            rsuite.SuiteSpec(sweeps=(rsuite.SweepSpec("oddshape", count=2),),
                             output="sweep.csv"),
            SuiteSpec(sweeps=(SweepSpec("oddshape", count=2),),
                      output="sweep.csv")),
    }[which]
    assert port.to_toml() == _mapped(ref.to_toml())
    assert port.to_json() == _mapped(ref.to_json())
    assert json.loads(port.to_json()) == port.to_dict()
    assert SuiteSpec.from_toml(_mapped(ref.to_toml())) == port
    assert SuiteSpec.from_json(port.to_json()) == port
    assert _port_of(ref) == port
    assert port.resolved_extents() == ref.resolved_extents()


def test_spec_fields_are_the_references_but_device_counts():
    ref = [f.name for f in dataclasses.fields(rsuite.SuiteSpec)]
    port = [f.name for f in dataclasses.fields(SuiteSpec)]
    assert port == [f for f in ref if f != "device_counts"]
    with pytest.raises(ValueError, match="unknown SuiteSpec key"):
        SuiteSpec.from_dict({"extents": ["64"], "device_counts": [1, 2]})


def test_spec_validation_errors_are_the_references():
    bad = [dict(kinds=("Sideways_Real",)), dict(precisions=("half",)),
           dict(rigor="vibes"), dict(batch=0), dict(format="xml"),
           dict(warmups=-1)]
    for kw in bad:
        with pytest.raises(ValueError) as ref:
            rsuite.SuiteSpec(**kw)
        with pytest.raises(ValueError) as port:
            SuiteSpec(**kw)
        assert str(port.value) == str(ref.value)
    for d in ({"extents": ["64"], "repititions": 3},
              {"sweep": [{"class": "oddshape", "depth": 2}]},
              {"sweep": [{"rank": 1}]}):
        with pytest.raises(ValueError) as ref:
            rsuite.SuiteSpec.from_dict(d)
        with pytest.raises(ValueError) as port:
            SuiteSpec.from_dict(d)
        # the known-key list differs by device_counts alone
        assert str(port.value).split("; known")[0] == \
            str(ref.value).split("; known")[0]
    with pytest.raises(ValueError, match="resolves no extents"):
        SuiteSpec(extents=()).build_nodes()


def test_files_cross_between_the_packages(tmp_path):
    """A spec file written by either package reads in the other once the
    titles are mapped, in TOML and in JSON."""
    for ext in ("toml", "json"):
        ref_path = str(tmp_path / f"ref.{ext}")
        port_path = str(tmp_path / f"port.{ext}")
        REF_FULL.save(ref_path)
        PORT_FULL.save(port_path)
        with open(ref_path) as f:
            ref_text = f.read()
        with open(port_path) as f:
            assert f.read() == _mapped(ref_text)
        assert SuiteSpec.from_file(port_path) == PORT_FULL
        back = rsuite.SuiteSpec.from_file(port_path)
        assert back.clients == tuple(TITLES[c] for c in REF_FULL.clients)
        assert back.resolved_extents() == PORT_FULL.resolved_extents()


def test_the_reference_example_spec_reads_here():
    path = os.path.join(ROOT, "examples", "suite.toml")
    ref = rsuite.SuiteSpec.from_file(path)
    with open(path, "rb") as f:
        d = tomllib.load(f)
    d["clients"] = [TITLES[c] for c in d["clients"]]
    port = SuiteSpec.from_dict(d)
    assert port.resolved_extents() == ref.resolved_extents()
    assert port == _port_of(ref)
    nodes = port.build_nodes()
    assert [n.path for n in nodes] == [
        "/".join([TITLES[n.client_cls.title]] + n.path.split("/")[1:])
        for n in ref.build_nodes()]


def test_select_filters_the_tree_as_the_reference():
    kw = dict(extents=("64", "16x16"), kinds=("Outplace_Real",
                                              "Inplace_Complex"),
              precisions=("float", "double"), select="*/double/16x16/*")
    port = SuiteSpec(clients=("TorchFFT", "TorchStockham"), **kw)
    ref = rsuite.SuiteSpec(clients=("XlaFFT", "Stockham"), **kw)
    got = [(n.client_cls.title, n.problem.extents, n.problem.kind,
            n.problem.precision) for n in port.build_nodes()]
    want = [(TITLES[n.client_cls.title], n.problem.extents, n.problem.kind,
             n.problem.precision) for n in ref.build_nodes()]
    assert got == want and len(got) == 4


# --------------------------------------------------------------------------
# ResultSet
# --------------------------------------------------------------------------
def _rows(mod):
    return [mod.Row("lib", "cpu", "64", 1, "powerof2", "float",
                    "Outplace_Real", "estimate", i, "execute_forward",
                    2.0 + i, 64, True, "") for i in range(3)] + \
           [mod.Row("lib", "cpu", "64", 1, "powerof2", "float",
                    "Outplace_Real", "measure", -1, "init_forward", 40.0, 0,
                    True, "", plan_cache="miss"),
            mod.Row("lib", "cpu", "64", 1, "powerof2", "float",
                    "Outplace_Real", "measure", 0, "init_inverse", 2.5, 0,
                    True, "", plan_cache="hit"),
            mod.Row("lib", "cpu", "64", 1, "powerof2", "float",
                    "Outplace_Real", "estimate", 0, "validate", 0.0, 0,
                    False, "boom")]


@pytest.mark.parametrize("cache", [True, False])
def test_summary_is_the_references(cache):
    from repro.core import results as rres
    from repro.core.plan import PlanCacheStats as RStats
    from repro_torch.core import results as pres
    stats = (PlanCacheStats(hits=1, misses=1, cold_ms=40.0),
             RStats(hits=1, misses=1, cold_ms=40.0)) if cache else (None,
                                                                      None)
    port = ResultSet(_rows(pres), columns_for(cache),
                     plan_stats=stats[0]).summary()
    ref = rsuite.ResultSet(_rows(rres), ref_columns_for(cache),
                           plan_stats=stats[1]).summary()
    assert port == ref
    assert port["latency_ms"]["p50"] == pytest.approx(3.0)
    assert ("plan_cache" in port) == cache


def test_result_set_counts_concat_and_save(tmp_path):
    from repro_torch.core import results as pres
    a = ResultSet(_rows(pres), COLUMNS)
    assert len(a) == a.n_rows == 6 and a.n_failures == 1
    assert [r.op for r in a][:1] == ["execute_forward"]
    both = ResultSet.concat([a, ResultSet(_rows(pres), COLUMNS)])
    assert both.n_rows == 12 and both.n_failures == 2
    path = both.save(str(tmp_path / "sub" / "all.csv"))
    assert both.path == path
    with open(path, newline="") as f:
        text = f.read()
    assert text == rows_to_csv(both.rows, COLUMNS) == both.to_csv_string()
    assert len(list(csv.DictReader(text.splitlines()))) == 12
    with pytest.raises(ValueError, match="different columns"):
        ResultSet.concat([a, ResultSet(_rows(pres), columns_for(True))])
    assert ResultSet.concat([]).columns == list(COLUMNS)


TINY = SuiteSpec(clients=("TorchFFT",), extents=("16",),
                 kinds=("Outplace_Real",), precisions=("float",),
                 warmups=0, repetitions=1, output=None)


def test_session_run_in_memory_and_streamed(tmp_path):
    session = Session(CPU)
    rs = session.run(TINY)
    assert rs.path is None and rs.n_rows > 0
    assert rs.query(op="validate")[0].success
    assert rs.columns == columns_for(True)
    assert rs.plan_stats is not None and rs.plan_stats.misses == 2
    assert session.run(TINY).plan_stats.misses == 2   # shared cache
    out = str(tmp_path / "s.log")
    rs = session.run(dataclasses.replace(TINY, output=out, format="jsonl",
                                         plan_cache=False))
    lines = [json.loads(line) for line in open(out)]
    assert rs.path == out and len(lines) == rs.n_rows
    assert list(lines[0]) == list(COLUMNS) and rs.plan_stats is None


def test_session_runs_a_sweep_spec():
    spec = SuiteSpec(clients=("TorchFFT", "TorchStockhamPallas"),
                     sweeps=(SweepSpec("powerof2", rank=1, min_exp=3,
                                       max_exp=4),
                             SweepSpec("oddshape", rank=2, count=1)),
                     kinds=("Outplace_Real",), precisions=("float",),
                     select="TorchFFT/*", warmups=0, repetitions=1,
                     output=None)
    rs = Session(CPU).run(spec)
    val = rs.query(op="validate")
    assert {(r.library, r.extents) for r in val} == {
        ("TorchFFT", "8"), ("TorchFFT", "16"), ("TorchFFT", "19x19")}
    assert all(r.success for r in val)


# --------------------------------------------------------------------------
# support matrix
# --------------------------------------------------------------------------
def test_support_matrix_is_the_references():
    assert SUPPORT_PROBE_EXTENTS == rsuite.SUPPORT_PROBE_EXTENTS
    port, ref = support_matrix(), rsuite.support_matrix()
    assert port == ref
    assert sum(r["supported"] for r in port) > len(port) // 2
    probes = {1: (12,), 2: (19, 19)}
    assert support_matrix(probes=probes) == rsuite.support_matrix(
        probes=probes)


def _supported_cells(backend):
    seen, cells = set(), []
    for row in support_matrix():
        if row["backend"] != backend or not row["supported"]:
            continue
        problem = Problem(row["extents"], row["kind"], row["precision"])
        # Inplace/Outplace run the same transform
        key = (problem.extents, problem.complex_input, problem.precision)
        if key not in seen:
            seen.add(key)
            cells.append(problem)
    return cells


@pytest.mark.parametrize("backend", REF_BACKENDS)
def test_every_supported_cell_runs_its_cpu_forward(backend):
    cells = _supported_cells(backend)
    assert cells
    for problem in cells:
        x = rand_input(problem, seed=len(problem.extents))
        y = _forward_fn(problem, Candidate(backend), "cpu")(
            torch.from_numpy(x))
        want = numpy_forward(problem, x)
        assert tuple(y.shape) == want.shape
        assert_rel_l2(y.numpy(), want, problem.precision,
                      f"{backend} {problem.signature()}")


# --------------------------------------------------------------------------
# make_plan(near=...)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("rigor", [PlanRigor.MEASURE, PlanRigor.WISDOM_ONLY])
def test_near_false_sweeps_where_near_takes_the_neighbor(rigor, tmp_path):
    wisdom = Wisdom(str(tmp_path / "w.json"), device_kind="cpu")
    wisdom.record(Problem((256,), "Outplace_Complex"), Candidate("stockham"),
                  measured_ms=1.0, rigor="measure")
    problem = Problem((512,), "Outplace_Complex")
    build = lambda c: _forward_fn(problem, c, "cpu")
    near = make_plan(problem, rigor, build=build, wisdom=wisdom,
                     device="cpu")
    assert near.source == "wisdom_near" and near.candidate.key() == "stockham"
    far = make_plan(problem, rigor, build=build, wisdom=wisdom,
                    device="cpu", near=False)
    if rigor is PlanRigor.WISDOM_ONLY:
        assert far is None
        return
    assert far.source == "measure" and len(far.measured_ms) > 1
    assert all(np.isfinite(list(far.measured_ms.values())))
    assert wisdom.lookup(problem) == far.candidate
