"""The port's plain-torch baselines against the reference's jnp ones.

``repro_torch.fft.stockham`` and ``repro_torch.fft.fourstep`` are the
planner's ``stockham`` and ``fourstep`` backends (no kernels).  The same
seeded numpy inputs go through ``repro.fft.stockham.fft`` /
``repro.fft.fourstep.fft`` and through the port's, forward and inverse,
complex64 and complex128, real input included; then the pinned clients
``TorchStockham`` and ``TorchFourStep`` run through ``Session.run`` and
their forward is held against the reference's ``jax_fft._forward_fn``
under the same backend.

Tolerance: rel-L2 <= 1e-5 (complex64) and <= 1e-12 (complex128): the
same tables from float64 angles and the same algorithm; only the
summation order differs.  A roundtrip check alone would pass a permuted,
transposed or conjugated transform that its own inverse undoes; these
compare the spectra.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.accuracy import rand_input, rel_l2

from repro.core import candidates as rc
from repro.core.client import Problem as RProblem
from repro.core.clients import jax_fft
from repro.fft import fourstep as r_fourstep
from repro.fft import stockham as r_stockham
from repro_torch.core.client import Problem, TorchContext
from repro_torch.core.clients.torch_fft import TorchFourStep, TorchStockham
from repro_torch.core.suite import Session, SuiteSpec
from repro_torch.core.tree import BenchNode
from repro_torch.fft import fourstep, stockham

TOL = {"float": 1e-5, "double": 1e-12}
CDTYPE = {"float": np.complex64, "double": np.complex128}
#: powers of two, one stage to twelve
STOCKHAM_NS = (1, 2, 8, 64, 256, 1024, 4096)
#: 13-smooth lengths: one product (<= 128), one split (1024 = 128 x 8,
#: 3072 = 128 x 24, 16384 = 128 x 128), and recursive splits above 128
#: (945 = 3 x 315 -> 3 x 105, 2197 = 13 x 169 -> 13 x 13,
#: 20480 = 128 x 160 -> 32 x 5)
FOURSTEP_NS = (1, 12, 100, 127, 128, 945, 1024, 2197, 3072, 16384, 20480)
MODULES = {"stockham": (stockham, r_stockham, STOCKHAM_NS),
           "fourstep": (fourstep, r_fourstep, FOURSTEP_NS)}
CASES = [(name, n) for name, (_, _, ns) in MODULES.items() for n in ns]


def _jit(ref):
    """The reference's fft traced once per shape (eagerly it dispatches
    every stage's ops one by one)."""
    return jax.jit(ref.fft, static_argnums=1)


def _rand(shape, precision, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(CDTYPE[precision])


@pytest.mark.parametrize("name,n", CASES,
                         ids=[f"{name}-{n}" for name, n in CASES])
@pytest.mark.parametrize("precision", ["float", "double"])
def test_baseline_matches_reference(name, n, precision):
    port, ref, _ = MODULES[name]
    batch = (3,) if n > 1024 else (2, 3)
    x = _rand((*batch, n), precision, seed=n)
    for inverse in (False, True):
        got = port.fft(torch.from_numpy(x), inverse).numpy()
        want = np.asarray(_jit(ref)(jnp.asarray(x), inverse))
        assert got.dtype == want.dtype == CDTYPE[precision]
        assert got.shape == want.shape == x.shape
        assert rel_l2(got, want) <= TOL[precision], (name, n, inverse)
        # and the transform itself, not one its own inverse would undo
        lib = (np.fft.ifft if inverse else np.fft.fft)(x.astype(np.complex128))
        assert rel_l2(got, lib) <= TOL[precision] * 100, (name, n, inverse)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_baseline_casts_real_input_to_complex64(name):
    port, ref, _ = MODULES[name]
    x = np.random.default_rng(7).standard_normal((4, 64))   # float64
    got = port.fft(torch.from_numpy(x)).numpy()
    want = np.asarray(ref.fft(jnp.asarray(x)))
    assert got.dtype == want.dtype == np.complex64
    assert rel_l2(got, want) <= TOL["float"]


def _forward(cls, problem, x):
    client = cls(problem, TorchContext("cpu"))
    client.allocate()
    client.init_forward()
    client.upload(x)
    client.execute_forward()
    return client._spec.numpy()


@pytest.mark.parametrize("cls,ext,kind,precision", [
    (TorchStockham, (64,), "Outplace_Complex", "float"),
    (TorchStockham, (16, 32), "Inplace_Real", "double"),
    (TorchFourStep, (100,), "Outplace_Real", "float"),
    (TorchFourStep, (12, 945), "Inplace_Complex", "double"),
], ids=["stockham-64-c", "stockham-16x32-r", "fourstep-100-r",
        "fourstep-12x945-c"])
def test_baseline_client_matches_reference_forward(cls, ext, kind, precision):
    problem = Problem(ext, kind, precision, batch=2)
    rs = Session(TorchContext("cpu")).run(
        SuiteSpec(output=None, warmups=0, repetitions=1),
        nodes=[BenchNode(cls, problem)])
    assert not rs.failures(), [r.error for r in rs.failures()]
    assert [r.success for r in rs.query(op="validate")] == [True]
    x = rand_input(problem, seed=21)
    got = _forward(cls, problem, x)
    want = np.asarray(jax_fft._forward_fn(
        RProblem(ext, kind, precision, 2),
        rc.Candidate(cls.backend_filter))(x))
    assert got.shape == want.shape
    assert rel_l2(got, want) <= TOL[precision]
