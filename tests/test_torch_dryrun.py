"""The port's dry run (``repro_torch.launch.dryrun``), its op counter
(``roofline/op_count.py``) and the roofline report
(``roofline/analysis.py``'s report half).

* The dry run of the reduced qwen3-1.7b on a fake (2, 2) group, in train,
  prefill and decode modes, each in its own process (a fake group is its
  process's default group): the record's keys are the reference's; the
  argument bytes equal a hand count from ``param_specs`` (this rank's
  shards of the float32 parameters, m and v, the step, its rows of the
  batch); FSDP's all-gathers over ``data`` and TP's all-reduces over
  ``model`` are counted.
* ``OpCounter`` on a (2, 2) product whose output is sharded on one axis
  and replicated on the other: per-device flops are the global product's
  / 2, not / 4.
* The train-mode argument bytes within 1% of the reference's compiled
  ``memory_analysis().argument_size_in_bytes`` for the same reduced
  config and cut shape on four fake XLA devices (this file's
  ``__main__``, in a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4``).
* The report half: the reference's ``tests/test_roofline.py`` table cases
  with the H100's constants.
"""

from __future__ import annotations

import builtins
import json
import math
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ARCH = "qwen3-1.7b"
#: the dry run's cut of a shape for ``--reduced``: (seq, global batch)
REDUCED_SEQ, REDUCED_BATCH = 64, 8


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", **extra)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The three modes' records, each traced in its own process, all
    started together, beside the reference's compiled argument bytes."""
    tmp = str(tmp_path_factory.mktemp("dryrun"))
    shapes = ("train_4k", "prefill_32k", "decode_32k")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", s, "--reduced", "--mesh", "2x2", "--out-dir", tmp],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for s in shapes]
    ref = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "reference", tmp],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = [p.communicate(timeout=600)[0] for p in procs]
    ref_log = ref.communicate(timeout=600)[0]
    out = {}
    for s, p, log in zip(shapes, procs, logs):
        assert p.returncode == 0, log[-3000:]
        with open(os.path.join(tmp, f"{ARCH}_{s}_2-2.json")) as f:
            out[s] = json.load(f)
    out["reference"] = (ref.returncode, ref_log, tmp)
    return out


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_record_has_the_references_keys(records, shape):
    rec = records[shape]
    for key in ("arch", "shape", "mesh", "status", "mode", "opt_level",
                "lower_s", "memory", "flops_per_device",
                "dot_bytes_per_device", "collectives"):
        assert key in rec, key
    assert rec["status"] == "ok" and rec["mesh"] == "2x2"
    assert rec["mode"] == shape.split("_")[0]
    assert rec["flops_per_device"] > 0 and rec["dot_bytes_per_device"] > 0
    coll = rec["collectives"]
    assert set(coll["by_kind"]) == set(coll["counts"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert coll["total_bytes"] == pytest.approx(sum(coll["by_kind"].values()))
    assert "argument_size_in_bytes" in rec["memory"]


def _local_numel(shape, spec, mesh) -> int:
    n = 1
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            n *= dim
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n *= dim // math.prod(mesh.shape[a] for a in axes)
    return n


def test_train_argument_bytes_are_the_hand_count(records):
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import param_specs

    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = get_config(ARCH).reduced()
    shell = Model(cfg, device="cpu").abstract_params()
    specs = param_specs(shell, mesh)
    params = sum(_local_numel(t.shape, specs[k], mesh) * t.element_size()
                 for k, t in shell.state_dict().items())
    tokens = REDUCED_BATCH // 2 * REDUCED_SEQ * 4   # int32 rows over data
    want = 3 * params + 4 + tokens                  # params, m, v; step
    assert records["train_4k"]["memory"]["argument_size_in_bytes"] == want
    assert torch.float32 == shell.embed.table.dtype


def test_fsdp_gathers_and_tp_reductions_are_counted(records):
    by_axis = records["train_4k"]["collectives"]["by_axis"]
    assert by_axis["data"]["all-gather"] > 0       # FSDP's weight gathers
    assert by_axis["data"]["reduce-scatter"] > 0   # their gradients
    assert by_axis["model"]["all-reduce"] > 0      # TP's partial sums
    counts = records["train_4k"]["collectives"]["counts"]
    assert counts["all-gather"] > 0 and counts["all-reduce"] > 0


def test_train_argument_bytes_match_the_references_compiled(records):
    rc, log, tmp = records["reference"]
    assert rc == 0, log[-3000:]
    with open(os.path.join(tmp, "reference_args.json")) as f:
        want = json.load(f)["argument_size_in_bytes"]
    got = records["train_4k"]["memory"]["argument_size_in_bytes"]
    assert abs(got - want) <= 0.01 * want, (got, want)


_PRODUCT = r"""
import json, sys, torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.dryrun import join_fake_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.roofline.op_count import analyze
join_fake_group(4)
dm = make_mesh((2, 2), ("data", "model")).device_mesh("cpu")
x = distribute_tensor(torch.empty(64, 32, device="meta"), dm,
                      [Shard(0), Replicate()], src_data_rank=None)
w = distribute_tensor(torch.empty(32, 16, device="meta"), dm,
                      [Replicate(), Replicate()], src_data_rank=None)
y, s = analyze(lambda: x @ w)
print(json.dumps({"flops": s["dot_flops"], "bytes": s["dot_bytes"],
                  "placements": str(y.placements)}))
"""


def test_op_count_takes_the_local_product():
    out = subprocess.run([sys.executable, "-c", _PRODUCT], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "Shard(dim=0)" in got["placements"] and \
        "Replicate()" in got["placements"]
    # rows over data (2 ways), replicated over model: half the product
    assert got["flops"] == 2 * 64 * 32 * 16 / 2
    assert got["bytes"] == 4 * (32 * 32 + 32 * 16 + 32 * 16)


# ---------------------------------------------------------------------------
# the report half (the reference's tests/test_roofline.py:33-67)
# ---------------------------------------------------------------------------
def _rec(**over):
    rec = {"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": "16x16",
           "status": "ok", "flops_per_device": 1e15,
           "dot_bytes_per_device": 1e12,
           "collectives": {"total_bytes": 1e9}, "lower_s": 1.0}
    rec.update(over)
    return rec


def test_unknown_mesh_becomes_skipped_row():
    from repro_torch.roofline.analysis import markdown_table, row_from_record
    row = row_from_record(_rec(mesh="4x4"))
    assert row.status == "skipped: unknown mesh 4x4"
    assert row.compute_s == 0.0
    assert "skipped: unknown mesh 4x4" in markdown_table([row])


def test_known_mesh_row_uses_the_h100s_constants():
    from repro_torch.roofline import analysis
    row = analysis.row_from_record(_rec())
    assert row.status == "ok"
    assert analysis.PEAK_FLOPS == 989e12 and analysis.HBM_BW == 3.35e12
    assert analysis.COLL_BW == 50e9
    assert row.compute_s == pytest.approx(1e15 / 989e12)
    assert row.memory_s == pytest.approx(1e12 / 3.35e12)
    assert row.collective_s == pytest.approx(1e9 / 50e9)
    assert row.dominant == "compute"
    assert row.roofline_fraction > 0
    assert analysis.CHIPS == {"16x16": 256, "2x16x16": 512}


def test_load_rows_closes_file_handles(tmp_path, monkeypatch):
    from repro_torch.roofline.analysis import load_rows
    for i in range(3):
        (tmp_path / f"r{i}.json").write_text(
            json.dumps(_rec(status="error")))
    opened = []
    real_open = builtins.open

    def tracking_open(*a, **kw):
        f = real_open(*a, **kw)
        opened.append(f)
        return f

    monkeypatch.setattr(builtins, "open", tracking_open)
    rows = load_rows(str(tmp_path), mesh=None)
    monkeypatch.undo()
    assert len(rows) == 3
    assert opened and all(f.closed for f in opened)


def test_report_renders_a_dry_run_directory(records, tmp_path):
    """``main`` over a directory of records (one renamed to a production
    mesh, so it is a row rather than a skip)."""
    import contextlib
    import io

    from repro_torch.roofline import analysis
    rec = dict(records["train_4k"], mesh="16x16")
    (tmp_path / "a.json").write_text(json.dumps(rec))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        analysis.main(["--dir", str(tmp_path)])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("| arch | shape | status")
    assert "| qwen3-1.7b | train_4k | ok |" in lines[2]


def _reference_args(tmp: str) -> None:
    """This file's ``__main__``: the reference's train step of the reduced
    config at the dry run's cut shape on a (2, 2) mesh of fake devices,
    compiled as its ``lower_cell`` compiles it; its argument bytes."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs.base import get_config, input_specs
    from repro.launch.mesh import make_mesh
    from repro.models.model import Model
    from repro.models.sharding import param_specs
    from repro.train.optimizer import OptConfig, init_opt_state
    from repro.train.trainer import build_train_step

    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = get_config(ARCH).reduced()
    model = Model(cfg, mesh=mesh, remat=True)
    p_shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    named = lambda t: jax.tree.map(  # noqa: E731
        lambda s: NamedSharding(mesh, s), t,
        is_leaf=lambda x: isinstance(x, P))
    p_shard = named(param_specs(p_shapes, mesh))
    o_shapes = jax.eval_shape(init_opt_state, p_shapes)
    o_shard = {"m": p_shard, "v": p_shard, "step": NamedSharding(mesh, P())}
    tokens = input_specs(cfg, "train_4k")["tokens"]
    tokens = jax.ShapeDtypeStruct((REDUCED_BATCH, REDUCED_SEQ), tokens.dtype)
    b_shard = {"tokens": NamedSharding(mesh, P(("data",), None))}
    micro = min(4, max(1, REDUCED_BATCH // 2))
    step = build_train_step(model, OptConfig(), microbatches=micro)
    with mesh:
        fn = jax.jit(step, in_shardings=(p_shard, o_shard, b_shard),
                     donate_argnums=(0, 1))
        compiled = fn.lower(p_shapes, o_shapes, {"tokens": tokens}).compile()
    mem = compiled.memory_analysis()
    with open(os.path.join(tmp, "reference_args.json"), "w") as f:
        json.dump({"argument_size_in_bytes":
                   int(mem.argument_size_in_bytes)}, f)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference_args(sys.argv[2])
