"""The port's gearshifft-style CLI (``repro_torch.core.cli``) against the
reference package's ``repro.core.cli``.

* the reference's argv lists parse to the reference's spec (client
  titles mapped) and to the same node tree;
* ``--dump-config`` prints the reference's golden text with ``TorchFFT``,
  in process and as ``python -m repro_torch.core.cli``, and ``--config``
  replays it to an equal spec, explicit flags overriding the file;
* ``main`` on a CPU session writes CSV and JSONL files with the
  reference's ``columns_for`` columns; an empty selection returns 1, and
  with no card and no session ``main`` raises rather than falling back to
  the CPU.
"""

import csv
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.core import cli as rcli
from repro.core.results import columns_for as ref_columns_for
from repro_torch.core import cli
from repro_torch.core.client import TorchContext
from repro_torch.core.suite import Session, SuiteSpec
from test_torch_tables import TITLES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

GOLDEN_ARGV = ["-e", "64", "--kinds", "Outplace_Real", "--precisions",
               "float", "--reps", "2", "--warmups", "0"]
GOLDEN = """\
clients = ["TorchFFT"]
extents = ["64"]
kinds = ["Outplace_Real"]
precisions = ["float"]
batch = 1
rigor = "estimate"
warmups = 0
repetitions = 2
error_bound = 1e-05
seed = 2017
plan_cache = true
verbose = false
output = "result.csv"
"""

#: The reference's argv lists (tests/test_suite.py) and a few more that
#: set every other flag; reference client titles.
ARGVS = {
    "tree": ["-e", "64", "16x16", "--client", "XlaFFT", "Stockham",
             "--kinds", "Outplace_Real", "Inplace_Complex",
             "--precisions", "float", "-r", "*/float/*/Outplace_Real",
             "-b", "2"],
    "defaults": [],
    "golden": GOLDEN_ARGV,
    "replay": ["-e", "16", "--client", "XlaFFT", "--kinds", "Outplace_Real",
               "--precisions", "float", "--reps", "1", "--warmups", "0"],
    "every_flag": ["-e", "8x8x8", "100", "--client", "Planned",
                   "StockhamPallas", "FourStepPallas", "--kinds",
                   "Inplace_Real", "--precisions", "float", "double",
                   "--rigor", "measure", "--warmups", "2", "--reps", "5",
                   "--error-bound", "1e-4", "--wisdom", "w.json",
                   "--no-plan-cache", "-o", "r.out", "--format", "jsonl",
                   "-b", "3", "-v", "-r", "*/double"],
}


def _port_argv(argv):
    return [TITLES.get(a, a) for a in argv]


def _map_text(text):
    for ref, port in TITLES.items():
        text = text.replace(f'"{ref}"', f'"{port}"')
    return text


def _node_key(node, titles=None):
    p = node.problem
    title = node.client_cls.title
    return ((titles or {}).get(title, title), p.extents, p.kind,
            p.precision, p.batch)


@pytest.mark.parametrize("name", list(ARGVS))
def test_cli_specs_and_trees_are_the_references(name):
    ref = rcli.spec_from_args(rcli.build_parser().parse_args(ARGVS[name]))
    port = cli.spec_from_args(cli.build_parser().parse_args(
        _port_argv(ARGVS[name])))
    assert port.to_toml() == _map_text(ref.to_toml())
    assert port == SuiteSpec.from_toml(_map_text(ref.to_toml()))
    nodes = port.build_nodes()
    assert nodes
    assert [_node_key(n) for n in nodes] == \
        [_node_key(n, TITLES) for n in ref.build_nodes()]
    assert [n.path.split("/", 1)[1] for n in nodes] == \
        [n.path.split("/", 1)[1] for n in ref.build_nodes()]


def test_cli_defaults_are_the_references_with_the_ports_titles():
    spec = cli.spec_from_args(cli.build_parser().parse_args([]))
    assert spec.clients == ("TorchFFT",)
    assert spec.extents == ((32, 32, 32),)
    assert spec.output == "result.csv" and spec.plan_cache is True
    assert cli._ARG_TO_FIELD == rcli._ARG_TO_FIELD
    port = {a.dest for a in cli.build_parser()._actions}
    ref = {a.dest for a in rcli.build_parser()._actions}
    assert port == ref


def test_dump_config_golden(capsys):
    assert cli.main(GOLDEN_ARGV + ["--dump-config"]) == 0
    assert capsys.readouterr().out == GOLDEN
    assert rcli.main(GOLDEN_ARGV + ["--dump-config"]) == 0
    assert _map_text(capsys.readouterr().out) == GOLDEN


def test_dump_config_as_a_program(capsys):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.cli", "--dump-config", "-"],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert rcli.main(["--dump-config", "-"]) == 0
    assert out.stdout == _map_text(capsys.readouterr().out)
    assert cli.SuiteSpec.from_toml(out.stdout) == cli.spec_from_args(
        cli.build_parser().parse_args([]))


def test_dump_config_then_config_replays(tmp_path, capsys):
    argv = _port_argv(ARGVS["replay"])
    spath = str(tmp_path / "spec.toml")
    assert cli.main(argv + ["--dump-config", spath]) == 0
    replayed = SuiteSpec.from_file(spath)
    direct = cli.spec_from_args(cli.build_parser().parse_args(argv))
    assert replayed == direct
    assert replayed.build_nodes() == direct.build_nodes()
    cpu = Session(TorchContext("cpu"))
    out_a, out_b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    assert cli.main(argv + ["-o", out_a], session=cpu) == 0
    assert cli.main(["--config", spath, "-o", out_b], session=cpu) == 0
    with open(out_a) as fa, open(out_b) as fb:
        assert fa.readline() == fb.readline()
    # an explicit flag overrides the file, the rest is the file's
    jpath = str(tmp_path / "spec.json")
    SuiteSpec(extents=("64",), repetitions=5, warmups=3,
              kinds=("Outplace_Real",)).save(jpath)
    capsys.readouterr()
    assert cli.main(["--config", jpath, "--reps", "1", "--dump-config"]) == 0
    out = capsys.readouterr().out
    assert "repetitions = 1" in out and "warmups = 3" in out
    assert 'extents = ["64"]' in out


@pytest.mark.parametrize("fmt,flags,plan_cache,plan_source", [
    ("csv", [], True, False),
    ("jsonl", [], True, False),
    ("csv", ["--no-plan-cache"], False, False),
    ("jsonl", ["--rigor", "measure", "--wisdom", "{tmp}/w.json",
               "--client", "TorchPlanned"], True, True),
])
def test_main_writes_the_reference_columns(fmt, flags, plan_cache,
                                           plan_source, tmp_path, capsys):
    out = str(tmp_path / f"r.{fmt}")
    flags = [f.replace("{tmp}", str(tmp_path)) for f in flags]
    argv = ["-e", "16", "8x8", "--kinds", "Outplace_Real", "Inplace_Complex",
            "--reps", "1", "--warmups", "0", "-o", out] + flags
    assert cli.main(argv, session=Session(TorchContext("cpu"))) == 0
    assert f"rows to {out}; 0 failures" in capsys.readouterr().out
    want = ref_columns_for(plan_cache, plan_source=plan_source)
    if fmt == "csv":
        with open(out) as f:
            rows = list(csv.DictReader(f))
        with open(out) as f:
            assert f.readline().strip().split(",") == want
    else:
        with open(out) as f:
            rows = [json.loads(line) for line in f]
        assert all(list(r) == want for r in rows)
    val = [r for r in rows if r["op"] == "validate"]
    assert len(val) == 4
    assert all(r["success"] in (True, "True") for r in val)


def test_empty_selection_returns_1(capsys):
    assert cli.main(["-e", "64", "-r", "NoSuchClient/*"],
                    session=Session(TorchContext("cpu"))) == 1
    assert "no benchmarks selected" in capsys.readouterr().out


def test_load_registers_more_clients(capsys):
    argv = ["--load", "repro_torch.benchmarks.table_kernels", "--client",
            "KernelStockhamTorch", "-e", "4096", "--dump-config"]
    assert cli.main(argv) == 0
    spec = SuiteSpec.from_toml(capsys.readouterr().out)
    assert spec.load == ("repro_torch.benchmarks.table_kernels",)
    assert spec.clients == ("KernelStockhamTorch",)


def test_main_without_a_card_raises_and_never_runs_on_the_cpu(monkeypatch,
                                                              tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        cli.main(["-e", "16", "-o", str(tmp_path / "r.csv")])
