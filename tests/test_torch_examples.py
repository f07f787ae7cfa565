"""The port's examples (``examples/torch_*``) against the reference's
(``examples/*.py``, ``examples/suite.toml``), each run once on the CPU.

The reference's examples are never run: their specs and configs are read
from their source (module constants, or the literal arguments of their
``SuiteSpec(...)`` / ``replace(...)`` calls) and built with the
reference's classes.

* the quickstart's and the suite example's specs equal the reference's
  after the title map; ``torch_suite.toml`` equals ``suite.toml`` after it
  and runs through the port's CLI on a CPU session;
* the quickstart and the suite example run whole on the CPU; the suite's
  failed nodes are ``expected_failures``: the nodes ``support_matrix``
  marks unsupported, less the plain four-step client's at lengths whose
  prime factors are at most 128 (its engine takes them, as the
  reference's FourStep client does);
* the distributed demo with ``--device cpu`` on 8 gloo ranks: rel-L2 <=
  1e-3 against numpy, the round trip within 1e-5, (n1, n2) the
  reference's ``_choose_1d_factors(2**14, 8)``, the Suite node validated;
* ``torch_serve_lm.py --device cpu`` finishes every request;
* ``torch_train_lm.py``'s variant configs equal the reference's field by
  field, its parameter count the reference's ``eval_shape`` count, and
  ``--steps 3`` then ``--steps 5`` on one directory resumes from 3.
"""

from __future__ import annotations

import ast
import contextlib
import csv
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys
import tomllib

import jax
import numpy as np
import pytest

from repro.core import suite as rsuite
from repro_torch.core import cli
from repro_torch.core.client import TorchContext
from repro_torch.core.suite import Session, SuiteSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
EXAMPLES = os.path.join(ROOT, "examples")

#: The reference's client titles and the port's.
TITLES = {"XlaFFT": "TorchFFT", "Stockham": "TorchStockham",
          "FourStep": "TorchFourStep", "Bluestein": "TorchBluestein",
          "Planned": "TorchPlanned", "DistFFT1D": "TorchDistFFT1D"}


def _load(name: str):
    """An example module, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _literal_calls(path: str, func: str) -> list[dict]:
    """The keyword arguments of every ``func(...)`` call in ``path`` whose
    keywords are all literals (positional arguments are dropped)."""
    tree = ast.parse(open(path).read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) \
                == func:
            try:
                out.append({k.arg: ast.literal_eval(k.value)
                            for k in node.keywords})
            except ValueError:
                continue
    return out


def _mapped(ref_spec) -> dict:
    d = ref_spec.to_dict()
    d["clients"] = [TITLES[c] for c in d["clients"]]
    return d


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, *args], env=env,
                          capture_output=True, text=True, timeout=timeout)


# --------------------------------------------------------------------------
# quickstart
# --------------------------------------------------------------------------
def test_quickstart_spec_is_the_references():
    kw, = _literal_calls(os.path.join(EXAMPLES, "quickstart.py"),
                         "SuiteSpec")
    qs = _load("torch_quickstart")
    assert qs.SPEC.to_dict() == _mapped(rsuite.SuiteSpec(**kw))


def test_quickstart_runs_on_the_cpu(tmp_path, monkeypatch):
    qs = _load("torch_quickstart")
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = qs.main(["--device", "cpu"])
    out = buf.getvalue()
    assert results.n_failures == 0
    val = results.query(op="validate")
    assert len(val) == 4 and all(r.success for r in val)
    assert len(results.aggregate(op="execute_forward")) == 4
    assert "python -m repro_torch.core.cli --config quickstart.toml" in out
    assert SuiteSpec.from_file(str(tmp_path / "quickstart.toml")) == qs.SPEC
    with open(tmp_path / "result.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == results.n_rows


# --------------------------------------------------------------------------
# the suite example and its TOML
# --------------------------------------------------------------------------
def test_suite_example_specs_are_the_references():
    ref = _load_reference_suite()
    ex = _load("torch_fft_benchmark_suite")
    assert ex.MAIN_SPEC.to_dict() == _mapped(ref.MAIN_SPEC)
    assert ex.RIGOR_SPEC.to_dict() == _mapped(ref.RIGOR_SPEC)
    assert ex.MAIN_SPEC.resolved_extents() == ref.MAIN_SPEC.resolved_extents()


def _load_reference_suite():
    spec = importlib.util.spec_from_file_location(
        "reference_fft_benchmark_suite",
        os.path.join(EXAMPLES, "fft_benchmark_suite.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)     # constants only: main is not called
    return mod


def test_suite_toml_is_the_references_and_runs(tmp_path):
    with open(os.path.join(EXAMPLES, "suite.toml"), "rb") as f:
        ref = tomllib.load(f)
    with open(os.path.join(EXAMPLES, "torch_suite.toml"), "rb") as f:
        port = tomllib.load(f)
    ref["clients"] = [TITLES[c] for c in ref["clients"]]
    assert port == ref
    path = os.path.join(EXAMPLES, "torch_suite.toml")
    spec = SuiteSpec.from_file(path)
    assert spec.resolved_extents() == \
        rsuite.SuiteSpec.from_file(os.path.join(EXAMPLES, "suite.toml")
                                   ).resolved_extents()
    out = str(tmp_path / "smoke.csv")
    assert cli.main(["--config", path, "-o", out],
                    session=Session(TorchContext("cpu"))) == 0
    with open(out) as f:
        val = [r for r in csv.DictReader(f) if r["op"] == "validate"]
    # four clients on 256, 512 and 1024 (the sweep and the extent)
    assert len(val) == 12
    assert all(r["success"] == "True" for r in val)


def test_suite_example_fails_only_the_unsupported_nodes(tmp_path):
    ex = _load("torch_fft_benchmark_suite")
    out = str(tmp_path / "suite.csv")
    with contextlib.redirect_stdout(io.StringIO()):
        combined = ex.main(["--device", "cpu", "--reps", "1", "-o", out])
    failed = {ex.failure_key(r.library, r.extents, r.kind, r.precision)
              for r in combined.failures()}
    expected = ex.expected_failures(ex.MAIN_SPEC) \
        | ex.expected_failures(ex.RIGOR_SPEC)
    assert failed == expected
    unsupported = ex.unsupported_nodes(ex.MAIN_SPEC)
    assert expected <= unsupported
    # the difference: the plain four-step client at 19, 361 and 6859
    assert {k[0] for k in unsupported - expected} == {"TorchFourStep"}
    assert {k[1] for k in unsupported - expected} == {"19", "361", "6859"}
    # the rigor runs: ESTIMATE, MEASURE and WISDOM_ONLY on 1024 and 4096,
    # the last two planned from the fresh wisdom
    planned = [r for r in combined.query(library="TorchPlanned")
               if r.op == "validate"]
    assert len(planned) == 6 and all(r.success for r in planned)
    sources = {r.rigor: r.plan_source for r in combined.query(
        library="TorchPlanned", op="init_forward")}
    assert sources["wisdom_only"] == "wisdom"
    with open(out) as f:
        assert sum(1 for _ in csv.DictReader(f)) == combined.n_rows


# --------------------------------------------------------------------------
# the distributed demo
# --------------------------------------------------------------------------
def test_distributed_demo_on_eight_gloo_ranks(tmp_path):
    from repro.fft.distributed import _choose_1d_factors

    report = str(tmp_path / "demo.json")
    out = _run([os.path.join(EXAMPLES, "torch_distributed_fft_demo.py"),
                "--device", "cpu", "--report", report])
    assert out.returncode == 0, out.stdout + out.stderr
    with open(report) as f:
        got = json.load(f)
    assert got["ranks"] == 8 and got["backend"] == "gloo"
    assert got["mesh3d"] == [2, 4]
    assert got["fft3d"]["rel_l2"] <= 1e-3
    assert got["fft1d"]["rel_l2"] <= 1e-3
    assert got["ifft1d"]["rel_l2"] <= 1e-5
    assert (got["fft1d"]["n1"], got["fft1d"]["n2"]) == \
        _choose_1d_factors(2 ** 14, 8)
    assert got["suite"]["validate"] == [[True, ""]]
    assert "TorchDistFFT1D n=4096 on 8 ranks" in out.stdout


def test_distributed_demo_needs_a_card_unless_asked():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    out = _run([os.path.join(EXAMPLES, "torch_distributed_fft_demo.py")],
               timeout=120)
    assert out.returncode != 0
    assert "--device cpu" in out.stderr


# --------------------------------------------------------------------------
# the LM examples
# --------------------------------------------------------------------------
def test_serve_example_finishes_every_request():
    out = _run([os.path.join(EXAMPLES, "torch_serve_lm.py"), "--device",
                "cpu"])
    assert out.returncode == 0, out.stderr
    assert "[serve] 8/8 requests" in out.stdout


def _reference_variants() -> dict:
    """The reference example's two configs: ``replace(base, ...)`` of
    qwen3-1.7b with each call's literal arguments."""
    from repro.configs.base import get_config as r_get_config

    calls = _literal_calls(os.path.join(EXAMPLES, "train_lm.py"), "replace")
    assert len(calls) == 2
    base = r_get_config("qwen3-1.7b")
    full, small = (dataclasses.replace(base, **kw) for kw in calls)
    return {True: full, False: small}


def _fields(cfg) -> dict:
    import torch
    out = dataclasses.asdict(cfg)
    d = out["dtype"]
    out["dtype"] = str(d).removeprefix("torch.") \
        if isinstance(d, torch.dtype) else np.dtype(d).name
    return out


@pytest.mark.parametrize("full", [True, False])
def test_train_example_variant_is_the_references(full):
    from repro.models.model import Model as RModel
    from repro_torch.models.model import Model

    ex = _load("torch_train_lm")
    cfg, ref = ex.variant_config(full), _reference_variants()[full]
    assert _fields(cfg) == _fields(ref)
    shapes = jax.eval_shape(RModel(ref, remat=False).init_params,
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    model = Model(cfg, device="cpu", remat=False)
    got = sum(p.numel() for p in model.abstract_params().parameters())
    assert got == want


def test_train_example_resumes_across_invocations(tmp_path):
    ex = _load("torch_train_lm")
    ckpt = str(tmp_path / "ck")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        first = ex.main(["--device", "cpu", "--steps", "3", "--ckpt", ckpt])
    assert first["step"] == 3 and "resumed" not in buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        second = ex.main(["--device", "cpu", "--steps", "5", "--ckpt", ckpt])
    assert "[trainer] resumed from step 3" in buf.getvalue()
    assert second["step"] == 5 and np.isfinite(second["loss"])
