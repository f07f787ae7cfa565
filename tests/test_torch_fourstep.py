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
from repro_torch.kernels.fft4step import fft4step as fs, ops, ref

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
    """The cap is the reference's 128*128 in both dtypes.  One block holds
    every split's padded plane and root tables in complex64 and up to
    13920 = 120*116 in complex128; a split that does not fit, such as
    13824 = 128*108 or 16384, runs as two launches."""
    assert ops.MAX_N == {torch.complex64: 16384, torch.complex128: 16384}
    for dtype, itemsize in ((torch.complex64, 8), (torch.complex128, 16)):
        assert ops.feasible(16384, dtype) and ops.feasible(4096, dtype)
        assert ops.feasible(8192, dtype) and not ops.feasible(131, dtype)
        assert not ops.feasible(32768, dtype)
        n1, n2 = ops.choose_factors(16384)
        assert ops.one_block(n1, n2, itemsize) == (itemsize == 8)
    assert ops.one_block(120, 116, 16)
    assert not ops.one_block(*ops.choose_factors(13824), 16)
    with pytest.raises(ValueError, match="factorization"):
        ops.fft(torch.zeros((1, 32768), dtype=torch.complex128))
    with pytest.raises(ValueError, match="factorization"):
        ops.fft(torch.zeros((1, 131), dtype=torch.complex64))


def test_two_launch_tiles_fit_half_a_block():
    """Each launch of the two-launch form holds a power-of-two count of
    panels within half a block's shared memory (two blocks an SM)."""
    for n in (13824, 14000, 16384, 128 * 125):
        n1, n2 = ops.choose_factors(n)
        assert not ops.one_block(n1, n2, 16)
        cols, rows = ops.pass_tiles(n1, n2, 16)
        panel = 8 * fs.n_tiles(n1, n2)
        for tile, plane in ((cols, n1 * fs.plane_pitch(cols)),
                            (rows, rows * fs.plane_pitch(n2))):
            assert tile % panel == 0 and (tile // panel) & (tile // panel - 1) == 0
            assert fs.smem_bytes(n1, n2, 0, 16) + plane * 16 \
                <= ops.SMEM_LIMIT_BYTES // 2
    assert ops.pass_tiles(128, 128, 16) == (32, 32)


@pytest.mark.parametrize("n", [16384, 13824])
def test_two_launch_lengths_match_pallas_interpret(n):
    """complex128 over one block's plane: the plain version (the same
    products, in the same order, as the two launches) against the
    reference's kernel in interpret mode and numpy."""
    x = rand_c((2, n), "double", seed=n)
    xt = torch.from_numpy(x)
    for inverse in (False, True):
        got = ops.fft(xt, inverse).numpy()
        want = np.asarray(ref_ops.fft(x, inverse, interpret=True, tile_b=1))
        assert rel_l2(got, want) <= REL_L2_TOL["double"], inverse
        numpy = (np.fft.ifft if inverse else np.fft.fft)(x)
        assert rel_l2(got, numpy) <= TOL["double"], inverse


@pytest.mark.parametrize("n", [4096, 16384])
def test_three_term_tf32_keeps_the_bar(n):
    """The kernel's complex64 arithmetic, modelled in torch: both products
    summed from TF32 parts (round to nearest, the 13 low mantissa bits
    dropped) hold rel-L2 1e-5 against the float64 oracle with three terms
    per product (3xTF32); one term (plain TF32) misses it."""
    x = torch.from_numpy(rand_c((3, n), "float", seed=n))
    t = ops.make_tables(n, False, torch.complex64, "cpu")
    want = (np.fft.fft(x.numpy().astype(np.complex128)))
    three = ref.apply_fourstep_tf32(x, t.w1, t.w2, t.t, terms=3).numpy()
    one = ref.apply_fourstep_tf32(x, t.w1, t.w2, t.t, terms=1).numpy()
    assert rel_l2(three, want) <= TOL["float"]
    assert rel_l2(one, want) > 10 * TOL["float"]
    # TF32 rounding: to nearest, ties away from zero, 10 mantissa bits
    v = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -12, 3.0])
    assert ref.tf32(v).tolist() == [1 + 2 ** -10, 1 + 4 * 2 ** -11,
                                    -(1 + 2 ** -10), 1.0, 3.0]


@pytest.mark.parametrize("precision", ["float", "double"])
def test_kernel_roots_rebuild_the_tables(precision):
    """The kernel's root vector: W1's and W2's roots are the tables' row 1
    (so W[r, j] = root[(r j) mod n1] exactly), and T's two root tables
    rebuild T as w^(128 (e >> 7)) * w^(e & 127) to within one rounding."""
    dtype = CDTYPE[precision][1]
    for n in (945, 4096, 8192):
        for inverse in (False, True):
            t = ops.make_tables(n, inverse, dtype, "cpu")
            n1, n2 = t.n1, t.n2
            r1, r2 = t.roots[:n1], t.roots[n1:n1 + n2]
            lo, hi = t.roots[n1 + n2:n1 + n2 + 128], t.roots[n1 + n2 + 128:]
            assert torch.equal(r1, t.w1[1]) and torch.equal(r2, t.w2[1])
            j = torch.arange(n1)
            assert torch.equal(r1[(j[:, None] * j[None, :]) % n1], t.w1)
            e = torch.arange(n1)[:, None] * torch.arange(n2)[None, :]
            built = hi[e >> 7] * lo[e & 127]
            assert rel_l2(built.numpy(), t.t.numpy()) <= \
                (1e-6 if precision == "float" else 1e-15)


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
