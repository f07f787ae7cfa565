"""The loader finds every part of every cell by its name, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import re

import _paths  # noqa: F401
import pytest

from perfbench import loader

BENCH = loader.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_found_by_name(name):
    cell = loader.cell(name)
    assert cell.chips == 1
    assert cell.config["extents"] and cell.config["precision"] == "float"
    assert cell.traffic["client"] == "TorchPlanned"
    assert set(cell.spec["limits"]) == {"spec_err", "roundtrip_err"}
    assert cell.spec["expect_plan"] in ("fourstep_pallas", "dft")
    assert {"exec_pair_ms", "exec_pair_p95_ms", "setup_s"} \
        == set(cell.end_to_end)
    roof = "fft4step_roofline" if name.startswith("pow2") else "dft_roofline"
    assert roof in cell.per_layer and len(cell.per_layer) == 6
    ref = loader.reference(cell.config["reference"])
    assert ref.CONTROL[cell.config["precision"]] == "tf32"


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    assert callable(loader.reader(metric))


def test_missing_parts_raise():
    with pytest.raises(KeyError):
        loader.cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        loader.reader("no_such_metric")


def test_benchmark_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [c["name"] for c in BENCH["configs"]] + CELLS \
        + [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    configs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert (loader.ROOT / c["file"]).is_file()
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(CELLS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
