"""The port's paper tables against the reference package's: ``overhead``
(Fig. 2), ``tts`` (Fig. 3), ``plan_rigor`` (Figs. 4-5), ``backends``
(Fig. 6), ``radix`` (Fig. 7) and ``dtypes`` (Fig. 8).

* each spec is the reference's with the port's client titles: the same
  extents, sweeps, kinds, precisions, warmups and plan-cache policy, and
  the same row names;
* on a CPU session (the kernels' plain versions) every node validates
  but the ones the support rules refuse (the Stockham kernel on 6859 =
  19^3, which is not 7-smooth), which are failed nodes with no row, as
  in the reference; ``plan_rigor`` has the reference's full row set, its
  ``estimate_fitted`` rows included, both packages having a fitted table
  (on a CPU session the H100 table falls back to the hand-written model).
"""

import os
import sys

import pytest

from dataclasses import replace

from repro_torch.benchmarks import run as prun
from repro_torch.benchmarks import table_backends as tb
from repro_torch.benchmarks import table_dtypes as td
from repro_torch.benchmarks import table_overhead as to
from repro_torch.benchmarks import table_plan_rigor as tp
from repro_torch.benchmarks import table_radix as tr
from repro_torch.benchmarks import table_tts as tt
from repro_torch.core.candidates import backend_supports
from repro_torch.core.client import TorchContext
from repro_torch.core.clients import torch_fft
from repro_torch.core.suite import Session

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:     # the reference's benchmarks/ package
    sys.path.insert(0, ROOT)
from benchmarks import run as ref_run  # noqa: E402
from benchmarks import table_backends as ref_tb  # noqa: E402
from benchmarks import table_dtypes as ref_td  # noqa: E402
from benchmarks import table_overhead as ref_to  # noqa: E402
from benchmarks import table_plan_rigor as ref_tp  # noqa: E402
from benchmarks import table_radix as ref_tr  # noqa: E402
from benchmarks import table_tts as ref_tt  # noqa: E402
from repro.core.suite import SweepSpec as RSweepSpec  # noqa: E402

#: The reference's client titles and the port's.
TITLES = {"XlaFFT": "TorchFFT", "Stockham": "TorchStockham",
          "FourStep": "TorchFourStep", "Bluestein": "TorchBluestein",
          "FourStepPallas": "TorchFourStepPallas",
          "StockhamPallas": "TorchStockhamPallas", "SixStep": "TorchSixStep",
          "Fft2Pallas": "TorchFft2Pallas", "ChirpZPallas": "TorchChirpZPallas",
          "Planned": "TorchPlanned"}
FIELDS = ("extents", "kinds", "precisions", "batch", "warmups", "plan_cache",
          "rigor")


def _same_spec(port, ref) -> None:
    assert port.clients == tuple(TITLES[c] for c in ref.clients)
    for field in FIELDS:
        assert getattr(port, field) == getattr(ref, field), field
    for title in port.clients:
        assert hasattr(torch_fft, title)
    d = ref.to_dict()
    d["clients"] = [TITLES[c] for c in d["clients"]]
    assert port.to_dict() == d


@pytest.mark.parametrize("tag", ["1d", "2d", "3d", "nonpow2"])
def test_backends_specs_are_the_reference(tag):
    assert list(tb.SPECS) == list(ref_tb.SPECS)
    _same_spec(tb.SPECS[tag], ref_tb.SPECS[tag])


def test_radix_spec_is_the_reference():
    _same_spec(tr.SPEC, ref_tr.SPEC)


def _run(module, capsys):
    """Run a table on a CPU session; returns its CSV row names and the
    nodes that failed."""
    session = Session(TorchContext("cpu"))
    module.run(reps=1, session=session)
    lines = capsys.readouterr().out.strip().splitlines()
    assert all(float(line.split(",")[1]) > 0 for line in lines)
    return [line.split(",")[0] for line in lines]


def test_nonpow2_and_radix_run_on_the_cpu(capsys, monkeypatch):
    """The oddshape rows: every node the support rules allow validates
    (one row each), the Stockham kernel on 19^3 is a failed node."""
    monkeypatch.setattr(tb, "SPECS", {"nonpow2": tb.SPECS["nonpow2"]})
    names = _run(tb, capsys)
    spec = tb.SPECS["nonpow2"]
    want = []
    for node in spec.build_nodes():
        if backend_supports(node.client_cls.backend_filter, node.problem):
            want.append(f"backend/nonpow2/{node.client_cls.title}/"
                        + "x".join(map(str, node.problem.extents)))
    assert sorted(names) == sorted(want)
    assert "backend/nonpow2/TorchStockhamPallas/6859" not in names
    assert len(want) == len(spec.build_nodes()) - 1
    names = _run(tr, capsys)
    assert len(names) == len(tr.SPEC.build_nodes())
    assert {n.split("/")[1] for n in names} == {"powerof2", "radix357",
                                                "oddshape"}


#: The reference's tts sweep (``benchmarks/table_tts.py``'s ``run``).
REF_TTS = replace(ref_tt.BASE, repetitions=3, sweeps=(
    RSweepSpec("powerof2", rank=3, min_exp=3, max_exp=5),))


@pytest.mark.parametrize("table", ["overhead", "tts", "plan_rigor",
                                   "dtypes_8a", "dtypes_8b"])
def test_paper_table_specs_are_the_reference(table):
    port, ref = {
        "overhead": (to.SPEC, ref_to.SPEC),
        "tts": (tt.spec(), REF_TTS),
        "plan_rigor": (tp.SPEC, ref_tp.SPEC),
        "dtypes_8a": (td.SPECS[0], ref_td.SPECS[0]),
        "dtypes_8b": (td.SPECS[1], ref_td.SPECS[1]),
    }[table]
    _same_spec(port, ref)
    assert tp.EXTENTS == ref_tp.EXTENTS and td.EXTENTS == ref_td.EXTENTS
    assert len(td.SPECS) == len(ref_td.SPECS)
    assert prun.TABLES == [t for t in ref_run.TABLES
                           if os.path.exists(os.path.join(
                               os.path.dirname(prun.__file__),
                               f"table_{t}.py"))]


def _names(spec, fmt) -> list[str]:
    """Row names a table gives each node of the reference's ``spec``."""
    return [fmt(TITLES[n.client_cls.title], n.problem)
            for n in spec.build_nodes()]


def _ext(p) -> str:
    return "x".join(map(str, p.extents))


def _ref_names(table) -> list[str]:
    if table == "overhead":
        return [f"overhead/{what}/{e}" for e in ("32x32x32", "64x64x64")
                for what in ("framework", "standalone_tts", "ratio")]
    if table == "tts":
        return (_names(REF_TTS, lambda t, p: f"tts/{t}/{_ext(p)}")
                + _names(REF_TTS, lambda t, p: f"fft_only/{t}/{_ext(p)}"))
    if table == "plan_rigor":
        return [f"{what}/{rigor}/{e}"
                for rigor in ("estimate", "measure", "wisdom_only",
                              "estimate_fitted")
                for what in ("plan_time", "fft_time")
                for e in ref_tp.EXTENTS]
    return [name for spec in ref_td.SPECS for name in _names(
        spec, lambda t, p: f"dtype/{p.kind}/{p.precision}/{_ext(p)}")]


@pytest.mark.parametrize("table", ["overhead", "tts", "plan_rigor",
                                   "dtypes"])
def test_paper_tables_run_on_the_cpu(table, capsys):
    """Each table on a CPU session (reps 1) emits one row per reference
    row name, with a positive time."""
    module = {"overhead": to, "tts": tt, "plan_rigor": tp, "dtypes": td}[table]
    assert os.path.exists(tp.FITTED_TABLE) and os.path.exists(
        ref_tp.FITTED_TABLE)
    names = _run(module, capsys)
    assert sorted(names) == sorted(_ref_names(table))
