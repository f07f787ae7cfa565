"""The check on the CPU at a size a test run holds: the port's client
comes out correct; the control (the reference in TF32 in its place) and
each planted fault come out not correct, with the cells' own limits."""

import time

import _paths  # noqa: F401
import pytest

from perfbench import control, harness, loader

#: cell -> a batch the CPU holds
SMALL = {"pow2-4096-c2c.exec": 4, "oddshape-19-c2c.exec": 96,
         "pow2-4096-r2c.exec": 4, "oddshape-19-r2c.exec": 96}


def _run(name, kind, seed=2 ** 31 + 11, seconds=0.3):
    cell = loader.cell(name)
    run = harness.run_cell(cell, seed, seconds, False, time.perf_counter(),
                           device="cpu", batch=SMALL[name],
                           make_client=control.make_client(kind))
    return run, harness.verdict(run)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_program_correct(name):
    run, (correct, failed, checks) = _run(name, "program")
    assert correct and failed == 0, checks
    assert run.plan == loader.cell(name).spec["expect_plan"]
    assert [e["pair"] for e in run.errors][0] == 0
    assert len(run.errors) >= 2
    assert run.pairs > run.errors[-1]["pair"]


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("kind", ["control", *control.FaultClient.FAULTS])
def test_control_and_faults_fail(name, kind):
    # the control's TF32 products are slow on the CPU: a longer window
    # reaches a later checked pair
    run, (correct, failed, checks) = _run(
        name, kind, seconds=0.3 if kind != "control" else 1.0)
    assert not correct
    assert failed >= 1
    assert any(c["value"] > c["limit"] for c in checks.values())


def test_same_seed_same_input():
    cell = loader.cell("oddshape-19-r2c.exec")
    p = cell.problem(5)
    a = harness.make_input(p, 2 ** 31 + 5, "cpu")
    b = harness.make_input(p, 2 ** 31 + 5, "cpu")
    c = harness.make_input(p, 2 ** 31 + 6, "cpu")
    assert a.equal(b) and not a.equal(c)
