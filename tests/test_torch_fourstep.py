"""The port's four-step kernel module against the reference Pallas kernel.

Inputs come from a seeded numpy generator and go through both packages:
the reference's ``fft4step`` runs in Pallas interpret mode, the port's
``ops.fft`` on a CPU tensor takes the kernel's plain version
(``ref.apply_fourstep``), fed the reference's own W1/W2/T planes
(``tables_from_reference``).

Tolerance: rel-L2 <= 1e-5 in float, <= 1e-12 in double against the
reference's kernel (the same split and tables, only the summation order
differs); against numpy the suite's bar, 1e-3 and 1e-8.
"""

import numpy as np
import pytest
import torch

from helpers.accuracy import REL_L2_TOL, rel_l2

from repro.fft import reference as ref_tables
from repro.kernels.fft4step import ops as ref_ops
from repro_torch.fft import reference as port_tables
from repro_torch.kernels.fft4step import ops, ref

TOL = {"float": 1e-5, "double": 1e-12}
CDTYPE = {"float": (np.complex64, torch.complex64),
          "double": (np.complex128, torch.complex128)}
REAL = {"float": np.float32, "double": np.float64}


def rand_c(shape, precision, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(CDTYPE[precision][0])


def test_choose_factors_matches_reference_for_every_n():
    for n in range(1, 128 * 128 + 2):
        try:
            want = ref_ops.choose_factors(n)
        except ValueError:
            with pytest.raises(ValueError):
                ops.choose_factors(n)
            continue
        got = ops.choose_factors(n)
        assert got == want, n
        assert got[0] <= 128 and got[1] <= 128 and got[0] * got[1] == n


def test_hopper_cap():
    """The cap is the longest factorable n whose signal and padded column
    DFTs fit one block; every factorable n beyond it is refused."""
    assert ops.MAX_N == {torch.complex64: 14464, torch.complex128: 7216}
    for dtype, itemsize in ((torch.complex64, 8), (torch.complex128, 16)):
        cap = ops.MAX_N[dtype]
        n1, n2 = ops.choose_factors(cap)
        assert ops.smem_bytes(n1, n2, 1, itemsize) <= ops.SMEM_LIMIT_BYTES
        assert ops.feasible(cap, dtype) and ops.feasible(4096, dtype)
        assert not ops.feasible(16384, dtype) and not ops.feasible(131, dtype)
        with pytest.raises(ValueError, match=f"caps at n={cap}"):
            ops.fft(torch.zeros((1, 128 * 128), dtype=dtype))
    with pytest.raises(ValueError, match="factorization"):
        ops.fft(torch.zeros((1, 131), dtype=torch.complex64))


@pytest.mark.parametrize("inverse", [False, True])
def test_tables_match_reference_tables(inverse):
    """The port's host tables are the reference's: float64 values equal,
    and each plan dtype is the float64 table cast once."""
    for n1, n2 in ((8, 16), (35, 27), (64, 64), (128, 113)):
        for got, want in (
                (port_tables.dft_matrix(n1, inverse, torch.complex128,
                                        device="cpu"),
                 ref_tables.dft_matrix(n1, inverse, np.complex128)),
                (port_tables.twiddles(n1, n2, inverse, torch.complex128,
                                      device="cpu"),
                 ref_tables.twiddles(n1, n2, inverse, np.complex128))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        n = n1 * n2
        for precision in ("float", "double"):
            if not ops.feasible(n, CDTYPE[precision][1]):
                continue
            t = ops.make_tables(n, inverse, CDTYPE[precision][1], "cpu")
            assert (t.n1, t.n2) == ops.choose_factors(n)
            want = np.asarray(ref_tables.twiddles(t.n1, t.n2, inverse,
                                                  np.complex128))
            np.testing.assert_array_equal(
                t.t.numpy(), want.astype(CDTYPE[precision][0]))
            assert t.inverse is inverse


def _reference_planes(n, inverse, precision):
    """The W1/W2/T planes the reference's ``ops.fft`` hands its kernel."""
    n1, n2 = ref_ops.choose_factors(n)
    real = REAL[precision]
    planes = []
    for z in (ref_tables.dft_matrix(n1, inverse, np.complex128),
              ref_tables.dft_matrix(n2, inverse, np.complex128),
              ref_tables.twiddles(n1, n2, inverse, np.complex128)):
        z = np.asarray(z)
        planes += [z.real.astype(real), z.imag.astype(real)]
    return planes


# (n, reference tile): a padded batch (5 rows in tiles of 2 or 8) and an
# exact one (tile 1); square, ragged-split and radix357 lengths
CASES = [(4, 2), (12, 8), (60, 2), (100, 1), (256, 2), (945, 8), (1024, 2)]


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("n,tile", CASES)
def test_fft_matches_pallas_interpret(n, tile, precision):
    x = rand_c((5, n), precision, seed=n + tile)
    xt = torch.from_numpy(x)
    for inverse in (False, True):
        plan = ops.tables_from_reference(
            *_reference_planes(n, inverse, precision), device="cpu")
        assert plan.inverse is inverse
        got = ops.fft(xt, inverse, twiddles=plan).numpy()
        want = np.asarray(ref_ops.fft(x, inverse, interpret=True,
                                      tile_b=tile))
        assert got.dtype == want.dtype == x.dtype
        assert rel_l2(got, want) <= TOL[precision], inverse
        numpy = (np.fft.ifft if inverse else np.fft.fft)(
            x.astype(np.complex128))
        assert rel_l2(got, numpy) <= REL_L2_TOL[precision], inverse


@pytest.mark.parametrize("precision", ["float", "double"])
def test_plain_versions_agree_with_numpy(precision):
    """The oracle and the kernel's plain version on a batch with two
    leading axes, a length whose split is not square, and length 1."""
    for n in (2, 7, 48, 1536, 3072):
        x = rand_c((2, 3, n), precision, seed=n)
        xt = torch.from_numpy(x)
        for inverse in (False, True):
            want = (np.fft.ifft if inverse else np.fft.fft)(
                x.astype(np.complex128))
            assert rel_l2(ref.fft4step_ref(xt, inverse), want) <= \
                TOL[precision]
            assert rel_l2(ops.fft(xt, inverse), want) <= TOL[precision]
    one = torch.ones((4, 1), dtype=torch.complex64)
    assert ops.fft(one, True) is one
    assert ops.fft(torch.ones((2, 8), dtype=torch.float64)).dtype == \
        torch.complex64
    plan = ops.make_tables(64, False, torch.complex64, "cpu")
    with pytest.raises(ValueError, match="do not match"):
        ops.fft(torch.zeros((1, 64), dtype=torch.complex64), True,
                twiddles=plan)
