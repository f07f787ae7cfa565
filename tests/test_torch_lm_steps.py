"""The port's ``lm_steps`` table (``repro_torch.benchmarks.table_lm_steps``)
and training launcher (``repro_torch.launch.train``) against the reference
package's ``benchmarks/table_lm_steps.py`` and ``launch/train.py``.

The spec, the client titles and the schedule are the reference's, key
for key; on a CPU session a train and a decode client run through
``Session.run`` and validate, and warm repetitions hit the plan cache.
"""

import dataclasses
import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import run as prun
from repro_torch.benchmarks import table_lm_steps as tl
from repro_torch.core.client import TorchContext
from repro_torch.core.registry import get_client
from repro_torch.core.suite import Session
from repro_torch.train.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
if ROOT not in sys.path:     # the reference's benchmarks/ package
    sys.path.insert(0, ROOT)
from benchmarks import run as ref_run  # noqa: E402
from benchmarks import table_lm_steps as ref_tl  # noqa: E402


def test_spec_and_titles_are_the_reference():
    assert tl.ARCHS == ref_tl.ARCHS
    assert (tl.SEQ_LEN, tl.BATCH) == (ref_tl.SEQ_LEN, ref_tl.BATCH)
    assert tl.SPEC.to_dict() == ref_tl.SPEC.to_dict()
    assert set(tl.CLIENTS) == set(ref_tl.CLIENTS)
    for key, cls in tl.CLIENTS.items():
        ref = ref_tl.CLIENTS[key]
        assert (cls.title, cls.arch, cls.mode) == \
            (ref.title, ref.arch, ref.mode)
        assert get_client(cls.title) is cls
    assert [dataclasses.astuple(s) for s in tl.LM_SCHEDULE.steps] == \
        [dataclasses.astuple(s) for s in ref_tl.LM_SCHEDULE.steps]
    assert tl.LM_SCHEDULE.name == ref_tl.LM_SCHEDULE.name
    assert "lm_steps" in prun.TABLES and "lm_steps" in ref_run.TABLES


def test_host_input_is_the_reference():
    problem = tl.SPEC.build_nodes()[0].problem
    for key, cls in tl.CLIENTS.items():
        got = cls.make_host_input(problem, 1234)["tokens"]
        want = ref_tl.CLIENTS[key].make_host_input(problem, 1234)["tokens"]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "xlstm-350m"])
def test_train_and_decode_clients_validate_on_the_cpu(arch):
    spec = dataclasses.replace(
        tl.SPEC, clients=(f"LMTrain-{arch}", f"LMDecode-{arch}"),
        repetitions=2)
    rows = Session(TorchContext("cpu")).run(spec).rows
    validate = [r for r in rows if r.op == "validate"]
    assert [r.library for r in validate] == list(spec.clients)
    assert all(r.success for r in validate), [r.error for r in validate]
    inits = [r.plan_cache for r in rows if r.op == "init_forward"]
    assert inits == ["miss", "hit", "hit"] * 2  # warmup's cold build
    steps = [r for r in rows if r.op == "execute_forward" and r.run >= 0]
    assert len(steps) == 4 and all(r.time_ms > 0 for r in steps)
    alloc = [r.bytes for r in rows if r.op == "allocate"]
    assert all(b > 0 for b in alloc)


def test_table_runs_on_a_cpu_session(capsys, monkeypatch):
    monkeypatch.setattr(tl, "SPEC", dataclasses.replace(
        tl.SPEC, clients=("LMTrain-qwen3-1.7b", "LMDecode-hymba-1.5b")))
    tl.run(reps=1, session=Session(TorchContext("cpu")))
    lines = capsys.readouterr().out.strip().splitlines()
    names = sorted(line.split(",")[0] for line in lines)
    assert names == ["lm/decode_step/hymba-1.5b", "lm/train_step/qwen3-1.7b"]
    assert all(line.endswith("reduced b4s64") for line in lines)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def test_launch_train_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "2", "--device", "cpu",
         "--checkpoint-dir", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[train] finished at step 2" in out.stdout
    assert CheckpointManager(str(tmp_path)).latest_step() == 2


def test_launch_train_flags_are_the_reference():
    from repro.launch import train as ref_train
    from repro_torch.launch import train
    flags, ref_flags = (set(re.findall(r'"(--[a-z-]+)"',
                                       inspect.getsource(m)))
                        for m in (train, ref_train))
    assert flags == ref_flags | {"--device"}


def test_launch_train_refuses_a_mesh_and_a_missing_card(monkeypatch):
    from repro_torch.launch import train
    with pytest.raises(SystemExit):
        train.main(["--reduced", "--mesh", "2x2", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
