"""The port's six-step composition (``fft/sixstep.py``) against the
reference package's.

Inputs come from a seeded numpy generator and go through both packages:
the reference's ``sixstep.fft`` runs its Pallas kernels in interpret mode,
the port's on CPU tensors takes its kernels' plain versions (the Stockham
kernel's register passes, the four-step kernel's products) with the same
float64-built tables.

Tolerance: rel-L2 <= 1e-5 (complex64) / 1e-12 (complex128) against the
reference (the same split, schedule and tables; only the summation order
differs) and the suite's 1e-3 / 1e-8 against numpy.
"""

import numpy as np
import pytest
import torch

from helpers.accuracy import REL_L2_TOL, rel_l2

from repro.fft import sixstep as ref_sixstep
from repro_torch.core.client import Problem, TorchContext
from repro_torch.core.clients.torch_fft import TorchSixStep
from repro_torch.core.suite import Session, SuiteSpec
from repro_torch.core.tree import BenchNode
from repro_torch.fft import sixstep

TOL = {"float": 1e-5, "double": 1e-12}
CDTYPE = {"float": (np.complex64, torch.complex64),
          "double": (np.complex128, torch.complex128)}


def rand_c(shape, precision, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(CDTYPE[precision][0])


def test_constants_are_the_reference():
    assert (sixstep.MAX_KERNEL_N2, sixstep.MAX_RESIDUAL_N, sixstep.MAX_N) \
        == (ref_sixstep.MAX_KERNEL_N2, ref_sixstep.MAX_RESIDUAL_N,
            ref_sixstep.MAX_N) == (1 << 14, 1 << 10, 1 << 24)


def test_choose_split_is_the_reference_at_every_power_of_two():
    """Every power of two 4 ... 2^24, at the default and at every n1
    override (valid or not: an invalid one falls back to the default)."""
    for k in range(2, 25):
        n = 1 << k
        assert sixstep.choose_split(n) == ref_sixstep.choose_split(n), n
        for j in range(0, k + 2):
            n1 = 1 << j
            assert sixstep.choose_split(n, n1) == \
                ref_sixstep.choose_split(n, n1), (n, n1)
        assert sixstep.choose_split(n, 3) == ref_sixstep.choose_split(n, 3)
    for bad in (1, 2, 3, 12, 100):
        with pytest.raises(ValueError):
            sixstep.choose_split(bad)
        with pytest.raises(ValueError):
            ref_sixstep.choose_split(bad)


def _cases():
    for n in (2, 4, 64, 256, 1024):
        yield n, None
    yield 64, 2
    yield 256, 16
    yield 1024, 32


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("n,n1", list(_cases()))
def test_forward_and_inverse_match_reference(n, n1, precision):
    x = rand_c((3, n), precision, seed=n + (n1 or 0))
    xt = torch.from_numpy(x)
    for inverse in (False, True):
        got = sixstep.fft(xt, inverse, n1=n1).numpy()
        want = np.asarray(ref_sixstep.fft(x, inverse=inverse, n1=n1,
                                          interpret=True))
        oracle = np.fft.ifft(x) if inverse else np.fft.fft(x)
        assert got.dtype == x.dtype
        assert rel_l2(got, want) <= TOL[precision], (n, n1, inverse)
        assert rel_l2(got, oracle) <= REL_L2_TOL[precision], (n, n1, inverse)


@pytest.mark.parametrize("precision", ["float", "double"])
def test_plan_holds_the_split_tables(precision):
    """A plan is the n1 Stockham twiddles, the n2 four-step tables and
    the (n2, n1) twiddle grid; a call given it builds nothing, and a plan
    for another split, direction or dtype is refused."""
    dtype = CDTYPE[precision][1]
    plan = sixstep.make_plan(1024, False, dtype, "cpu", n1=32)
    assert (plan.n1, plan.n2) == (32, 32)
    assert plan.grid.shape == (32, 32) and plan.grid.dtype == dtype
    assert plan.first.n == 32 and plan.second.n1 * plan.second.n2 == 32
    assert plan.nbytes == (plan.first.nbytes + plan.second.nbytes
                           + plan.grid.numel() * plan.grid.element_size())
    x = torch.from_numpy(rand_c((2, 1024), precision, 3))
    want = sixstep.fft(x, n1=32)
    assert torch.equal(sixstep.fft(x, n1=32, plan=plan), want)
    for bad in (dict(n1=64), dict(inverse=True)):
        with pytest.raises(ValueError, match="does not match"):
            sixstep.fft(x, plan=plan, **{"n1": 32, **bad})
    with pytest.raises(ValueError, match="caps at"):
        sixstep.make_plan(1 << 25, False, dtype, "cpu")


@pytest.mark.parametrize("kind", ["Outplace_Complex", "Inplace_Complex",
                                  "Outplace_Real", "Inplace_Real"])
@pytest.mark.parametrize("precision", ["float", "double"])
def test_client_runs_every_kind_on_the_cpu(kind, precision):
    """``TorchSixStep`` through ``Session.run`` on small problems of each
    kind (a packed real half of 2 runs the Stockham kernel alone), every
    node round-trip validated."""
    nodes = [BenchNode(TorchSixStep, Problem(ext, kind, precision, 2))
             for ext in ((4,), (256,), (16, 64))]
    rs = Session(TorchContext("cpu")).run(
        SuiteSpec(output=None, warmups=0, repetitions=1), nodes=nodes)
    assert not rs.failures(), [r.error for r in rs.failures()]
    assert len(rs.query(op="validate")) == len(nodes)
