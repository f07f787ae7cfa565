"""No run imports JAX or the JAX package, and no run falls back to the
CPU."""

import os
import subprocess
import sys

import _paths

CODE = """
import sys, time
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import control, harness, loader, run
cell = loader.cell("oddshape-19-r2c.exec")
r = harness.run_cell(cell, 3, 0.1, False, time.perf_counter(), device="cpu",
                     batch=8)
assert harness.verdict(r)[0], r.errors
print(run.forbidden_modules(), sorted({{m.split(".")[0] for m in sys.modules}}
                                      & {{"jax", "jaxlib", "flax", "repro"}}))
"""


def test_harness_and_port_import_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", CODE.format(root=str(_paths.ROOT),
                                           src=str(_paths.ROOT / "src"))],
        capture_output=True, text=True, timeout=300, cwd=_paths.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def test_forbidden_modules_compares_whole_names():
    from perfbench import run

    added = ("repro_torch.fake_mod", "jaxlike", "repro.fake_mod")
    try:
        sys.modules[added[0]] = sys.modules[added[1]] = sys
        assert run.forbidden_modules() == []
        sys.modules[added[2]] = sys
        assert run.forbidden_modules() == ["repro"]
    finally:
        for name in added:
            sys.modules.pop(name, None)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "pow2-4096-c2c.exec", "--seed", "4294967311", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=_paths.ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr
