"""``repro_torch.benchmarks.update_experiments`` against the reference's
``tools/update_experiments.py``, on dry-run records made from a seed.

The reference's tool is loaded from its file; its ``ROOT``, ``EXP``,
``TUNED`` and ``BASE`` and ``repro.roofline.analysis``'s peaks are set to
the port's values by monkeypatch (nothing in the reference is edited).
Both fill the same ``EXPERIMENTS.md`` text: the roofline tables are equal
text (but for one header word: the port's useful ratio is over counted
flops, ``roofline/op_count.py``, where the reference's is over XLA's HLO),
the perf tables equal but for the FITS/OOM word, which each side decides
by its own device's memory (the port's: the H100's 80 GB less 2 GiB).
Records in the port's schema (no ``temp_size_in_bytes``) print "not
counted".
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

import numpy as np
import pytest

from repro.roofline import analysis as ranalysis
from repro_torch.benchmarks import update_experiments as ue
from repro_torch.roofline import analysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2017
#: every PERF_CELLS cell and one more cell, at 16x16
CELLS = ue.PERF_CELLS + [("qwen3-1.7b", "train_4k")]
#: The roofline table's one header word that differs: what the flops were
#: counted from.
HEADER = ("(6ND/HLO)", "(6ND/counted)")
TEXT = ("# Experiments\n\n## Roofline\n\n<!-- ROOFLINE_TABLE -->\n\n"
        "## Perf\n\n<!-- PERF_TABLE -->\n")


def _records(seed: int, temp: bool) -> list[dict]:
    """One ok record a cell, its counts drawn from ``seed``; temp bytes
    (the reference's schema) span both sides of both memory limits."""
    rng = np.random.default_rng(seed)
    out = []
    for arch, shape in CELLS:
        mem = {"argument_size_in_bytes": int(rng.uniform(0.05, 8) * 2**30)}
        if temp:
            mem["temp_size_in_bytes"] = int(rng.uniform(1, 90) * 2**30)
        out.append({
            "arch": arch, "shape": shape, "mesh": "16x16", "status": "ok",
            "mode": "train" if shape.startswith("train") else "prefill",
            "lower_s": float(rng.uniform(1, 100)), "memory": mem,
            "flops_per_device": float(rng.uniform(1e13, 2e14)),
            "dot_bytes_per_device": float(rng.uniform(1e11, 2e12)),
            "collectives": {"total_bytes": float(rng.uniform(1, 80) * 2**30)}})
    return out


def _write(d, records) -> str:
    os.makedirs(d, exist_ok=True)
    for rec in records:
        with open(os.path.join(d, f"{rec['arch']}_{rec['shape']}_16-16.json"),
                  "w") as f:
            json.dump(rec, f)
    return d


def _reference_tool(monkeypatch, root: str):
    spec = importlib.util.spec_from_file_location(
        "reference_update_experiments",
        os.path.join(ROOT, "tools", "update_experiments.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "ROOT", root)
    monkeypatch.setattr(mod, "EXP", os.path.join(root, "EXPERIMENTS.md"))
    monkeypatch.setattr(mod, "TUNED", os.path.join(root, "experiments",
                                                   "dryrun"))
    monkeypatch.setattr(mod, "BASE", os.path.join(root, "experiments",
                                                  "dryrun_baseline"))
    monkeypatch.setattr(ranalysis, "PEAK_FLOPS", analysis.PEAK_FLOPS)
    monkeypatch.setattr(ranalysis, "HBM_BW", analysis.HBM_BW)
    monkeypatch.setattr(ranalysis, "ICI_BW", analysis.COLL_BW)
    return mod


def _both(tmp_path, monkeypatch, temp: bool) -> dict:
    """Fill one EXPERIMENTS.md with each tool over the same records."""
    out = {}
    for side in ("ref", "port"):
        root = str(tmp_path / side)
        tuned = _write(os.path.join(root, "experiments", "dryrun"),
                       _records(SEED, temp))
        base = _write(os.path.join(root, "experiments", "dryrun_baseline"),
                      _records(SEED + 1, temp))
        exp = os.path.join(root, "EXPERIMENTS.md")
        with open(exp, "w") as f:
            f.write(TEXT)
        table = os.path.join(root, "experiments", "roofline_table.md")
        if side == "ref":
            _reference_tool(monkeypatch, root).main()
        else:
            assert ue.main(["--experiments", exp, "--tuned", tuned,
                            "--baseline", base, "--out", table]) == 0
        with open(exp) as f, open(table) as g:
            text, tab = f.read(), g.read()
        if side == "ref":
            text, tab = (t.replace(*HEADER) for t in (text, tab))
        out[side] = {"text": text, "table": tab}
    return out


def _sections(text: str) -> tuple[str, str]:
    roofline, perf = text.split("## Perf")
    return roofline, perf


def test_roofline_table_is_the_references(tmp_path, monkeypatch):
    both = _both(tmp_path, monkeypatch, temp=True)
    assert both["port"]["table"] == both["ref"]["table"]
    assert _sections(both["port"]["text"])[0] == \
        _sections(both["ref"]["text"])[0]
    assert both["port"]["table"].count("| ok |") == len(CELLS)


def test_perf_table_is_the_references_but_the_verdict(tmp_path,
                                                      monkeypatch):
    both = _both(tmp_path, monkeypatch, temp=True)
    word = re.compile(r"\((FITS|OOM)\)")
    port, ref = (_sections(both[s]["text"])[1] for s in ("port", "ref"))
    assert word.sub("(?)", port) == word.sub("(?)", ref)
    # each verdict by the port's own limit, and some differ from the
    # reference's 14 GiB
    records = {(r["arch"], r["shape"]): r for r in _records(SEED, True)}
    verdicts = re.findall(r"\| (\S+) × (\S+) \| temp GiB/chip \| .*? \| "
                          r"[\d.]+ \((FITS|OOM)\) \|", port)
    assert len(verdicts) == len(ue.PERF_CELLS)
    for arch, shape, verdict in verdicts:
        mem = records[(arch, shape)]["memory"]
        gib = (mem["temp_size_in_bytes"] + mem["argument_size_in_bytes"]) \
            / 2**30
        assert verdict == ("FITS" if gib < ue.FIT_LIMIT_GIB else "OOM")
    assert word.findall(port) != word.findall(ref)


def test_records_without_temp_bytes_are_not_counted(tmp_path):
    root = tmp_path / "port"
    tuned = _write(str(root / "tuned"), _records(SEED, temp=False))
    base = _write(str(root / "base"), _records(SEED + 1, temp=False))
    exp = str(root / "EXPERIMENTS.md")
    with open(exp, "w") as f:
        f.write(TEXT)
    ue.main(["--experiments", exp, "--tuned", tuned, "--baseline", base,
             "--out", str(root / "table.md")])
    text = open(exp).read()
    temp_rows = [ln for ln in text.splitlines() if "temp GiB/chip" in ln]
    assert len(temp_rows) == len(ue.PERF_CELLS)
    for ln in temp_rows:
        assert ln.count("not counted") == 2
        assert "FITS" not in ln and "OOM" not in ln
    assert "<!--" not in text


@pytest.mark.parametrize("temp", [True, False])
def test_both_markers_are_replaced(tmp_path, temp):
    root = tmp_path / "port"
    tuned = _write(str(root / "tuned"), _records(SEED, temp))
    exp = str(root / "EXPERIMENTS.md")
    with open(exp, "w") as f:
        f.write(TEXT)
    ue.main(["--experiments", exp, "--tuned", tuned, "--baseline", tuned,
             "--out", str(root / "table.md")])
    text = open(exp).read()
    assert "<!-- ROOFLINE_TABLE -->" not in text
    assert "<!-- PERF_TABLE -->" not in text
    assert "| arch | shape |" in text and "| cell | metric |" in text
