"""The port's perf-trajectory and cost-model layers against the
reference package's.

* the comparison core (``core/compare.py``): the committed trajectory
  documents load, diff and report to the same text in both packages, and
  ``benchmarks/bench_diff.py`` prints what ``tools/bench_diff.py`` prints
  and exits with its code;
* the bench grid (``benchmarks/bench_grid.py``) on the CPU in smoke mode:
  the reference's ``load_bench`` reads its document, which aligns with
  ``benchmarks/baselines/BENCH_smoke.json`` row for row with the same
  feasibility;
* the helpers (``Wisdom.measurements``, ``spearman``, ``CostModel.scaled``,
  the FFT roofline) equal the reference's on committed or seeded inputs;
* the fitter (``benchmarks/fit_costmodel.py``) gives the scales of
  ``benchmarks/baselines/costmodel_cpu.json`` from its own inputs, on the
  backends whose modeled bytes the two packages share; ESTIMATE under a
  scaled model picks the reference's on the planner's problems;
* the committed H100 baselines read in both packages, and the committed
  table is what the fitter makes of the committed grid and wisdom.

Exact equality everywhere: the same stdlib arithmetic on the same inputs.
"""

import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from repro.core import compare as rcmp
from repro.core import costmodel as rcm
from repro.core.candidates import Candidate as RCandidate
from repro.core.client import Problem as RProblem
from repro.core.wisdom import Wisdom as RWisdom
from repro.roofline import analysis as ranalysis
from repro_torch.benchmarks import bench_diff, bench_grid, fit_costmodel
from repro_torch.benchmarks import pregen_wisdom
from repro_torch.core import compare as pcmp
from repro_torch.core import costmodel as pcm
from repro_torch.core.candidates import Candidate, backend_supports
from repro_torch.core.client import Problem
from repro_torch.core.extents import parse_extents
from repro_torch.core.wisdom import Wisdom
from repro_torch.roofline import analysis as panalysis

from test_torch_planner import PROBLEMS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BASELINES = os.path.join(ROOT, "benchmarks", "baselines")
H100_BASELINES = os.path.join(ROOT, "src", "repro_torch", "benchmarks",
                              "baselines")
H100 = "NVIDIA H100 80GB HBM3"
SMOKE = os.path.join(REF_BASELINES, "BENCH_smoke.json")
TRAJECTORY = [os.path.join(ROOT, f"BENCH_PR{i}.json") for i in range(3, 8)]
#: What ``costmodel_cpu.json`` was fitted from (its meta's ``inputs``).
CPU_FIT_BENCH = [SMOKE] + TRAJECTORY
CPU_FIT_WISDOM = [os.path.join(REF_BASELINES, "wisdom_cpu.json")]


def _tool(name: str):
    """The reference's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"ref_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # its dataclasses resolve through it
    spec.loader.exec_module(mod)
    return mod


DOC_PAIRS = [(TRAJECTORY[i], TRAJECTORY[i + 1]) for i in range(4)] + [
    (TRAJECTORY[2], SMOKE), (SMOKE, SMOKE)]


@pytest.mark.parametrize("pair", DOC_PAIRS,
                         ids=lambda p: "-".join(os.path.basename(x)[:-5]
                                                for x in p))
def test_compare_reports_match_reference(pair):
    a, b = pair
    port = [pcmp.load_bench(p) for p in pair]
    ref = [rcmp.load_bench(p) for p in pair]
    for pd, rd in zip(port, ref):
        assert pd.rows == rd.rows and pd.meta == rd.meta
        assert pcmp.fig7_report(pd) == rcmp.fig7_report(rd)
    for pth, rth in ((pcmp.Thresholds(), rcmp.Thresholds()),
                     (pcmp.SMOKE_THRESHOLDS, rcmp.SMOKE_THRESHOLDS)):
        got = pcmp.diff_docs(*port, pth)
        want = rcmp.diff_docs(*ref, rth)
        assert pcmp.markdown_report(got) == rcmp.markdown_report(want)
        assert [r.verdict for r in got.rows] == [r.verdict for r in want.rows]


@pytest.mark.parametrize("argv", [
    [TRAJECTORY[0], TRAJECTORY[1]],
    [TRAJECTORY[2], TRAJECTORY[4], "--smoke"],
    [TRAJECTORY[1], TRAJECTORY[0], "--fail-on-missing"],
    [SMOKE, SMOKE, "--fail-on-missing", "--sigma", "1", "--min-rel", "0"],
    [TRAJECTORY[2], SMOKE, "--no-fail"],
    [os.path.join(ROOT, "no_such_bench.json"), SMOKE],
], ids=["default", "smoke", "missing", "custom", "no-fail", "unreadable"])
def test_bench_diff_matches_reference_tool(argv, capsys, tmp_path):
    ref = _tool("bench_diff")
    rc_ref = ref.main(argv + ["--md", str(tmp_path / "ref.md")])
    out_ref = capsys.readouterr()
    rc = bench_diff.main(argv + ["--md", str(tmp_path / "port.md")])
    out = capsys.readouterr()
    assert (rc, out.out) == (rc_ref, out_ref.out)
    if rc != 2:
        assert (tmp_path / "port.md").read_text() == \
            (tmp_path / "ref.md").read_text()
    else:
        assert "bench_diff:" in out.err


def test_smoke_grid_on_the_cpu_aligns_with_the_reference(tmp_path, capsys):
    out, report = tmp_path / "BENCH_cpu.json", tmp_path / "fig7.md"
    assert bench_grid.main(["--device", "cpu", "--smoke", "--out", str(out),
                            "--report", str(report)]) == 0
    assert "wrote 54 records" in capsys.readouterr().out
    doc = rcmp.load_bench(str(out))         # the reference's reader
    meta = doc.meta
    assert meta["schema"] == rcmp.SCHEMA_VERSION == pcmp.SCHEMA_VERSION
    assert (meta["device_kind"], meta["platform"], meta["devices"]) == \
        ("cpu", "cpu", 1)
    assert meta["interpret_kernels"] is True and "power_limit" not in meta
    assert meta["torch"] == torch.__version__ and meta["batch"] == 4
    res = rcmp.diff_docs(rcmp.load_bench(SMOKE), doc, rcmp.SMOKE_THRESHOLDS)
    assert res.count("added") == res.count("removed") == 0
    assert len(res.rows) == len(bench_grid.SMOKE_EXTENTS) * len(
        bench_grid.DEFAULT_BACKENDS)
    # the same feasibility, row for row, as the reference's grid
    ref_ok = {rcmp.row_key(r): r["ok"] for r in rcmp.load_bench(SMOKE).rows}
    assert {rcmp.row_key(r): r["ok"] for r in doc.rows} == ref_ok
    for row in doc.rows:
        if not row["ok"]:
            assert row["error"] == "unsupported extents/rank"
            continue
        assert row["n"] == 1 and row["sd_ms"] == 0.0
        assert 0 < row["time_ms"] == row["mean_ms"]
        assert row["model_flops"] == ranalysis.fft_model_flops(
            row["extent"].split("x"), 4)
        assert 0 < row["model_bytes"] < math.inf
        assert "roofline_fallback" not in row
        assert row["roofline_frac"] == panalysis.fft_roofline_frac(
            row["time_ms"], row["model_flops"], row["model_bytes"], "cpu")
    assert report.read_text() == pcmp.fig7_report(pcmp.load_bench(str(out)))


def test_grid_never_falls_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda:0 runs")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench_grid.main(["--smoke", "--out", str(tmp_path / "b.json")])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pregen_wisdom.main(["--out", str(tmp_path / "w.json")])


def test_infeasible_verdict_and_the_roofline_fallback():
    problem = Problem((12,), "Outplace_Complex", "float", batch=4)
    verdict = pcm.DEFAULT_MODEL.estimate(problem, Candidate("stockham"))
    assert isinstance(verdict, pcm.Infeasible) and not verdict
    assert float(verdict) == math.inf and "stockham" in verdict.reason
    assert pcm.estimate_bytes_moved(problem, Candidate("stockham")) == math.inf
    assert verdict != math.inf        # a verdict, not a float: compare float()
    rec = {}
    bench_grid._annotate_roofline(rec, problem, Candidate("stockham"), 1e-3,
                                  "cpu")
    assert rec["roofline_fallback"] == verdict.reason
    assert rec["model_bytes"] == 2.0 * problem.signal_bytes
    rec = {}
    bench_grid._annotate_roofline(rec, problem, Candidate("xla"), 1e-3, "cpu")
    assert "roofline_fallback" not in rec
    assert rec["model_bytes"] == rcm.DEFAULT_MODEL.estimate_bytes_moved(
        RProblem((12,), "Outplace_Complex", "float", batch=4),
        RCandidate("xla"))


def test_wisdom_measurements_match_reference():
    path = CPU_FIT_WISDOM[0]
    key = lambda m: (m[0].signature(), m[1].key(), m[2])
    got = sorted(map(key, Wisdom(path, device_kind="cpu").measurements()))
    want = sorted(map(key, RWisdom(path, device_kind="cpu").measurements()))
    assert got == want and len(got) == 26
    assert Wisdom(path, device_kind="tpu").measurements() == []


def _seeded_scales(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {b: float(10 ** rng.uniform(-1.0, 1.2))
            for b in sorted(pcm.BACKEND_COEFFS)}


@pytest.mark.parametrize("helper", ["spearman", "scaled", "fft_model_flops",
                                    "fft_roofline_frac", "device_peaks"])
def test_helpers_match_reference(helper):
    rng = np.random.default_rng(7)
    if helper == "spearman":
        for n in (0, 1, 2, 5, 40):
            xs = rng.integers(0, 6, n).astype(float).tolist()   # with ties
            ys = rng.standard_normal(n).tolist()
            for a, b in ((xs, ys), (xs, xs), (ys, [1.0] * n)):
                got, want = pcm.spearman(a, b), rcm.spearman(a, b)
                assert got == want or (math.isnan(got) and math.isnan(want))
        with pytest.raises(ValueError):
            pcm.spearman([1.0], [1.0, 2.0])
    elif helper == "scaled":
        assert pcm.BACKEND_COEFFS == rcm.BACKEND_COEFFS
        for seed in (0, 1):
            s = _seeded_scales(seed)
            got = pcm.DEFAULT_MODEL.scaled(s, device_kind="k", source="x")
            want = rcm.DEFAULT_MODEL.scaled(s, device_kind="k", source="x")
            assert got.coeffs.to_dict() == want.coeffs.to_dict()
            assert (got.device_kind, got.source) == ("k", "x")
        assert pcm.DEFAULT_MODEL.scaled({}).coeffs == pcm.DEFAULT_COEFFICIENTS
    elif helper == "fft_model_flops":
        for ext in ((1,), (7,), (4096,), (3, 5), (16, 16, 16), (19, 361)):
            for batch in (1, 4, 1024):
                assert panalysis.fft_model_flops(ext, batch) == \
                    ranalysis.fft_model_flops(ext, batch)
    elif helper == "fft_roofline_frac":
        for _ in range(50):
            t, f, b = (float(10 ** rng.uniform(-3, 2)),
                       float(10 ** rng.uniform(3, 12)),
                       float(10 ** rng.uniform(3, 10)))
            assert panalysis.fft_roofline_frac(t, f, b, "cpu") == \
                ranalysis.fft_roofline_frac(t, f, b, "cpu")
        for args in ((0.0, 1.0, 1.0), (1.0, math.inf, math.inf),
                     (1.0, 0.0, -1.0)):
            assert panalysis.fft_roofline_frac(*args, "cpu") == \
                ranalysis.fft_roofline_frac(*args, "cpu")
    else:
        assert panalysis.device_peaks("cpu") == ranalysis.device_peaks("cpu")
        assert panalysis.device_peaks(H100) == (67e12, 3.35e12)
        assert panalysis.device_peaks("unknown") == \
            ranalysis.DEVICE_PEAKS["cpu"]


def _both_price(o) -> bool:
    rp = RProblem(o.problem.extents, o.problem.kind, o.problem.precision,
                  o.problem.batch)
    return math.isfinite(rcm.DEFAULT_MODEL.estimate_bytes_moved(
        rp, RCandidate(o.cand.backend, o.cand.options)))


def test_fit_reproduces_the_reference_cpu_table():
    """The port's collectors read the reference's inputs; on the
    observations both models can price (the reference's Stockham VMEM cap
    refuses three that the port's column passes take), the split and the
    fit give ``costmodel_cpu.json``'s scales on every backend whose
    modeled bytes agree on every observation."""
    ref_fit = _tool("fit_costmodel")
    ref_obs = (ref_fit.bench_observations(CPU_FIT_BENCH)[0]
               + ref_fit.wisdom_observations(CPU_FIT_WISDOM)[0])
    obs = (fit_costmodel.bench_observations(CPU_FIT_BENCH)[0]
           + fit_costmodel.wisdom_observations(CPU_FIT_WISDOM)[0])
    assert [o.key() for o in obs] == [o.key() for o in ref_obs]
    disagree = {o.backend for o, r in zip(obs, ref_obs)
                if pcm.DEFAULT_MODEL.estimate_bytes_moved(o.problem, o.cand)
                != rcm.DEFAULT_MODEL.estimate_bytes_moved(r.problem, r.cand)}
    assert disagree == {"stockham_pallas"}
    kept, dropped = fit_costmodel.predictable(obs)
    both = [o for o in kept if _both_price(o)]
    assert (len(obs), dropped, len(both)) == (216, 0, 213)
    train, _ = fit_costmodel.split_train_test(both)
    scales = fit_costmodel.fit_scales(train)
    with open(os.path.join(REF_BASELINES, "costmodel_cpu.json")) as f:
        want = json.load(f)["backend_scales"]["cpu"]
    assert set(scales) == set(want)
    for backend in set(want) - disagree:
        assert scales[backend] == pytest.approx(want[backend], abs=1e-9)


@pytest.mark.parametrize("seed", [0, 1])
def test_fitted_estimate_picks_match_reference(seed):
    s = _seeded_scales(seed)
    port = pcm.DEFAULT_MODEL.scaled(s)
    ref = rcm.DEFAULT_MODEL.scaled(s)
    moved = 0
    for name, (ext, kind, precision, batch) in PROBLEMS.items():
        got = port.estimate_choice(Problem(ext, kind, precision, batch))
        want = ref.estimate_choice(RProblem(ext, kind, precision, batch))
        assert got.key() == want.key(), name
        hand = pcm.DEFAULT_MODEL.estimate_choice(
            Problem(ext, kind, precision, batch))
        moved += got.key() != hand.key()
        with pcm.use_model(port):
            assert pcm.estimate_choice(
                Problem(ext, kind, precision, batch)).key() == got.key()
    assert moved > 0          # the scales reach the picks
    assert pcm.get_active_model() is pcm.DEFAULT_MODEL


def test_pregen_and_fit_on_the_cpu(tmp_path, capsys):
    wisdom, table = str(tmp_path / "w.json"), str(tmp_path / "t.json")
    assert pregen_wisdom.main(["--device", "cpu", "--extents", "64", "48",
                               "--out", wisdom]) == 0
    got = Wisdom(wisdom, device_kind="cpu").measurements()
    assert sorted(m[0].signature() for m in got) == [
        "48/float/Outplace_Complex/b1", "48/float/Outplace_Real/b1",
        "64/float/Outplace_Complex/b1", "64/float/Outplace_Real/b1"]
    with open(wisdom) as f:
        assert {r["rigor"] for r in json.load(f).values()} == {"measure"}
    assert fit_costmodel.main([SMOKE, "--wisdom", wisdom, "--out", table,
                               "--assert-kind", "cpu"]) == 0
    assert pcm.model_for_device("cpu", table).device_kind == "cpu"
    assert set(rcm.load_tables(table)) == {"cpu"}
    assert fit_costmodel.main([os.path.join(ROOT, "README.md")]) == 2
    capsys.readouterr()


def test_committed_h100_baselines(tmp_path, capsys):
    """The committed H100 grid reads in both packages and names the card
    and its power limit; the committed table is what the fitter makes of
    the committed grid and wisdom, keyed by the card's kind (a CPU session
    keeps the hand-written model), and it beats the hand-written table's
    held-out rank correlation."""
    bench = os.path.join(H100_BASELINES, "BENCH_h100.json")
    wisdom = os.path.join(H100_BASELINES, "wisdom_h100.json")
    table = os.path.join(H100_BASELINES, "costmodel_h100.json")
    ref_doc, doc = rcmp.load_bench(bench), pcmp.load_bench(bench)
    assert ref_doc.rows == doc.rows
    meta = doc.meta
    assert (meta["device_kind"], meta["platform"]) == (H100, "gpu")
    assert meta["power_limit"].startswith(H100 + ", ")
    assert meta["interpret_kernels"] is False and meta["batch"] == 1024
    keys = {(r["backend"], r["extent"]) for r in doc.rows}
    assert keys == {(b, e) for b in bench_grid.DEFAULT_BACKENDS
                    for e in bench_grid.DEFAULT_EXTENTS}
    for r in doc.rows:
        p = Problem(parse_extents(r["extent"]), r["kind"], r["precision"],
                    r["batch"])
        assert r["ok"] == backend_supports(r["backend"], p), r
    assert Wisdom(wisdom, device_kind=H100).measurements()
    with open(table) as f:
        committed = json.load(f)
    rho = committed["held_out_rho"][H100]
    assert rho["fitted"] > rho["hand_written"]
    assert committed["power_limits"] == {H100: meta["power_limit"]}
    refit = str(tmp_path / "costmodel_h100.json")
    assert fit_costmodel.main([bench, "--wisdom", wisdom, "--out", refit,
                               "--assert-improves",
                               "--assert-kind", H100]) == 0
    with open(refit) as f:
        assert json.load(f) == committed
    capsys.readouterr()
    fitted = pcm.model_for_device(H100, table)
    assert fitted.device_kind == H100 and fitted is not pcm.DEFAULT_MODEL
    assert pcm.model_for_device("cpu", table) is pcm.DEFAULT_MODEL
    assert set(rcm.load_tables(table)) == {H100}
