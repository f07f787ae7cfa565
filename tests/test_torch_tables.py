"""The port's ``backends`` and ``radix`` tables (the paper's Figs. 6 and
7) against the reference package's.

* each spec is the reference's with the port's client titles: the same
  extents, kinds, precisions, warmups and plan-cache policy, and the
  same row names;
* on a CPU session (the kernels' plain versions) every node validates
  but the ones the support rules refuse (the Stockham kernel on 6859 =
  19^3, which is not 7-smooth), which are failed nodes with no row, as
  in the reference.
"""

import os
import sys

import pytest

from repro_torch.benchmarks import table_backends as tb
from repro_torch.benchmarks import table_radix as tr
from repro_torch.core.candidates import backend_supports
from repro_torch.core.client import TorchContext
from repro_torch.core.clients import torch_fft
from repro_torch.core.suite import Session

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:     # the reference's benchmarks/ package
    sys.path.insert(0, ROOT)
from benchmarks import table_backends as ref_tb  # noqa: E402
from benchmarks import table_radix as ref_tr  # noqa: E402

#: The reference's client titles and the port's.
TITLES = {"XlaFFT": "TorchFFT", "Stockham": "TorchStockham",
          "FourStep": "TorchFourStep", "Bluestein": "TorchBluestein",
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
