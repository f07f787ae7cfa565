"""The port's dft_matmul kernel module against the reference Pallas kernel.

Inputs come from a seeded numpy generator and go through both packages:
the reference's ``ops.dft`` runs its Pallas kernel in interpret mode, the
port's ``ops.dft`` on a CPU tensor takes the kernel's plain version
(``ref.apply_fft`` for a 7-smooth n, ``ref.apply_chirp`` for any other);
the two plain oracles (``dft_ref``) are compared on the same planes.

Tolerance: rel-L2 <= 1e-5 for complex64 and <= 1e-12 for complex128
against the reference and numpy: the same DFT from tables built in
float64 and cast to the plane dtype; the FFT bodies differ from the
reference's direct product in their factorization (the chirp body also
in its convolution at a length m >= 2n - 1), whose rounding (~log m ulps)
stays well inside these bars.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.accuracy import rel_l2

from repro.fft import reference as ref_tables
from repro.kernels.dft_matmul import ops as ref_ops
from repro.kernels.dft_matmul import ref as ref_ref
from repro_torch.kernels.dft_matmul import dft_matmul, ops, ref
from repro_torch.kernels.stockham_pallas.stockham_pallas import smooth7

TOL = {"float": 1e-5, "double": 1e-12}
CDTYPE = {"float": (np.complex64, torch.complex64),
          "double": (np.complex128, torch.complex128)}
NS = (1, 2, 3, 7, 8, 64, 100, 127, 128)
#: batch shapes: 5 and 2x3 rows pad the reference's tile of 8, 300 rows
#: its tile of 256
BATCHES = {1: (5,), 2: (2, 3), 3: (300,), 7: (5,), 8: (2, 3), 64: (300,),
           100: (5,), 127: (2, 3), 128: (300,)}


def rand_c(shape, precision, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(CDTYPE[precision][0])


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("n", NS)
def test_dft_matches_reference_kernel(n, precision, inverse):
    x = rand_c((*BATCHES[n], n), precision, seed=n)
    want = np.asarray(ref_ops.dft(jnp.asarray(x), inverse, interpret=True))
    launches = ops.LAUNCHES
    got = ops.dft(torch.from_numpy(x), inverse)
    assert ops.LAUNCHES == launches       # a CPU tensor never launches
    assert got.dtype == CDTYPE[precision][1] and got.shape == x.shape
    assert rel_l2(got.numpy(), want) <= TOL[precision]
    # the plain oracles on the same planes (no 1/n, as in the reference)
    xr = np.ascontiguousarray(x.real)
    xi = np.ascontiguousarray(x.imag)
    wr, wi = ref_ref.dft_ref(jnp.asarray(xr), jnp.asarray(xi), inverse)
    gr, gi = ref.dft_ref(torch.from_numpy(xr), torch.from_numpy(xi), inverse)
    assert gr.dtype == torch.from_numpy(xr).dtype
    assert rel_l2(gr.numpy() + 1j * gi.numpy(),
                  np.asarray(wr) + 1j * np.asarray(wi)) <= TOL[precision]


@pytest.mark.parametrize("real", [np.float32, np.float64])
def test_real_input_is_cast_to_complex64(real):
    """The reference's ``ops.dft`` casts real input to complex64 at any
    width (``bluestein`` widens differently); the port does the same."""
    x = np.random.default_rng(3).standard_normal((6, 100)).astype(real)
    want = np.asarray(ref_ops.dft(jnp.asarray(x), interpret=True))
    got = ops.dft(torch.from_numpy(x))
    assert want.dtype == np.complex64 and got.dtype == torch.complex64
    assert rel_l2(got.numpy(), want) <= TOL["float"]


@pytest.mark.parametrize("precision", ["float", "double"])
def test_plan_table_is_the_reference_table(precision):
    """A 7-smooth n's plan is the table of its n forward roots (row 1 of
    the reference's forward table); any other n's is the chirp body's
    table: the m roots (row 1 of the reference's m-point table), the chirp
    and the filter spectrum.  One table for both directions."""
    np_dtype, dtype = CDTYPE[precision]
    itemsize = np.dtype(np_dtype).itemsize
    for n in (3, 100, 127, 128):
        for inverse in (False, True):
            m = ops.make_matrix(n, inverse, dtype, "cpu")
            smooth = n != 127
            assert m.fft == smooth
            assert m.inverse is None
            if smooth:
                want = np.asarray(ref_tables.dft_matrix(
                    n, False, jnp.complex128)).astype(np_dtype)
                assert np.array_equal(m.w.numpy(), want[1])
                assert m.nbytes == n * itemsize
            else:
                assert m.m == 256
                want = np.asarray(ref_tables.dft_matrix(
                    256, False, jnp.complex128)).astype(np_dtype)
                assert np.array_equal(m.roots.numpy(), want[1])
                c, f = _chirp_numpy(n, 256)
                assert rel_l2(m.chirp.numpy(), c) <= TOL[precision]
                assert rel_l2(m.spectrum.numpy(), f) <= TOL[precision]
                assert m.nbytes == (n + 2 * 256) * itemsize


def _chirp_numpy(n, m):
    """The chirp c[j] = exp(-i pi j^2 / n) and the spectrum of conj(c)
    laid circularly on m points, over m: float64 numpy, the direct sum."""
    j = np.arange(n)
    c = np.exp(-1j * np.pi * ((j * j) % (2 * n)) / n)
    b = np.zeros(m, complex)
    b[:n] = np.conj(c)
    b[m - n + 1:] = np.conj(c[1:])[::-1]
    k = np.arange(m)
    f = np.exp(-2j * np.pi * (np.outer(k, k) % m) / m) @ b
    return c, f / m


@pytest.mark.parametrize("precision", ["float", "double"])
def test_chirp_plan_matches_an_independent_build(precision):
    """At every n <= 128 that is not 7-smooth: m = m1 * m2 >= 2n - 1, both
    factors register-FFT sizes, the split of the fewest flops of those;
    the chirp and the spectrum (over m) are the float64 numpy build's,
    cast once; the spectrum lies in natural order, the order k1 + m1 k2 in
    which a lane holds the product."""
    np_dtype, dtype = CDTYPE[precision]
    sizes = dft_matmul.CHIRP_SIZES
    for n in range(1, 129):
        if smooth7(n):
            continue
        m1, m2 = dft_matmul.chirp_split(n)
        m = m1 * m2
        assert m >= 2 * n - 1 and m1 <= m2 and m <= 2 * dft_matmul.MAX_N
        assert m1 in sizes and m2 in sizes
        assert set(sizes) <= set(dft_matmul.FFT_SIZES)
        assert all(dft_matmul.chirp_flops(a, b) >= dft_matmul.chirp_flops(
            m1, m2) for a in sizes for b in sizes if a * b >= 2 * n - 1)
        plan = ops.make_matrix(n, False, dtype, "cpu")
        assert plan.m == m and not plan.fft
        c, f = _chirp_numpy(n, m)
        tol = TOL[precision]
        assert rel_l2(plan.chirp.numpy(), c) <= tol, n
        assert rel_l2(plan.spectrum.numpy(), f) <= tol, n
        assert rel_l2(plan.roots.numpy(),
                      np.exp(-2j * np.pi * np.arange(m) / m)) <= tol, n
    assert dft_matmul.chirp_split(127) == (16, 16)
    assert dft_matmul.chirp_split(19) == (5, 8)
    assert dft_matmul.chirp_split(11) == (3, 8)


def test_register_fft_flops_count_the_kernel_steps():
    """``reg_fft_flops`` at every chirp size: the first DIF radix as the
    kernel takes it (``ref.first_radix``), its butterflies, the twiddles
    on the outputs u > 0 of the columns q > 0, then the sub-FFTs; the
    radix-8 butterfly is two radix-4 ones, two rot8 and eight adds."""
    bf = dft_matmul.BUTTERFLY_FLOPS
    assert bf[8] == 2 * bf[4] + 2 * 4 + 8 * 2
    want = {2: 4, 3: 18, 4: 16, 8: 56, 16: 4 * 16 + 6 * 9 + 4 * 16,
            12: 3 * 16 + 6 * 3 * 2 + 4 * 18, 6: 3 * 4 + 6 * 2 + 2 * 18}
    for m, flops in want.items():
        assert dft_matmul.reg_fft_flops(m) == flops, m
    for m in dft_matmul.CHIRP_SIZES:
        r = ref.first_radix(m)
        q = m // r
        assert dft_matmul.reg_fft_flops(m) == (
            bf[m] if q == 1 else q * bf[r] + 6 * (r - 1) * (q - 1)
            + r * dft_matmul.reg_fft_flops(q)), m


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("precision", ["float", "double"])
def test_chirp_model_agrees_with_the_direct_product(precision, inverse):
    """``ref.apply_chirp`` (the chirp body's steps) against the oracle
    ``ref.dft_ref`` and ``ref.apply_dft`` (the n x n product) at every n
    <= 128 that is not 7-smooth, on a ragged batch."""
    for n in range(11, 129):
        if smooth7(n):
            continue
        x = torch.from_numpy(rand_c((3, n), precision, seed=n))
        plan = ops.make_matrix(n, inverse, x.dtype, "cpu")
        got = ref.apply_chirp(x, plan.roots, plan.chirp, plan.spectrum,
                              *dft_matmul.chirp_split(n), inverse)
        yr, yi = ref.dft_ref(x.real.contiguous(), x.imag.contiguous(),
                             inverse)
        scale = n if inverse else 1
        direct = torch.complex(yr, yi) / scale
        table = torch.from_numpy(np.array(ref_tables.dft_matrix(
            n, inverse, jnp.complex128))).to(x.dtype)
        assert rel_l2(got.numpy(), direct.numpy()) <= TOL[precision], n
        assert rel_l2(got.numpy(), (ref.apply_dft(x, table) / scale).numpy()
                      ) <= TOL[precision], n


#: The FFT body's lengths (powers of two, 12, 50 = 5 x 10, 60, 100 =
#: 10 x 10, 105 = 7 x 15) and the chirp body's (11, 13, 19, 23, 97, 113,
#: 127: m = 21, 25, 40, 45, 196, 225, 256).
REFERENCE_NS = (2, 8, 12, 50, 60, 64, 100, 105, 128, 11, 13, 19, 23, 97,
                113, 127)


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("n", REFERENCE_NS)
def test_plain_version_matches_reference_kernel(n, precision):
    """Both bodies' plain versions against the reference's kernel in
    interpret mode, forward and inverse, on a ragged batch."""
    x = rand_c((5, n), precision, seed=1000 + n)
    m = {inv: ops.make_matrix(n, inv, CDTYPE[precision][1], "cpu")
         for inv in (False, True)}
    assert m[False].fft == smooth7(n)
    for inverse in (False, True):
        want = np.asarray(ref_ops.dft(jnp.asarray(x), inverse, interpret=True))
        got = ops.dft(torch.from_numpy(x), inverse, matrix=m[inverse])
        assert rel_l2(got.numpy(), want) <= TOL[precision], inverse


@pytest.mark.parametrize("precision", ["float", "double"])
def test_every_length_agrees_with_numpy(precision):
    """Every n from 1 to 128, forward and inverse: the FFT body's plain
    version on its split (7-smooth n), the chirp body's on the rest."""
    for n in range(1, 129):
        x = rand_c((3, n), precision, seed=n)
        for inverse in (False, True):
            want = (np.fft.ifft if inverse else np.fft.fft)(
                x.astype(np.complex128))
            got = ops.dft(torch.from_numpy(x), inverse)
            assert rel_l2(got.numpy(), want) <= TOL[precision], (n, inverse)


def test_fft_split_uses_register_sizes():
    """Every 7-smooth n <= 128 splits into two register-FFT sizes, the
    larger at most 16 (25 for n = 125), the loads' runs (n2) no shorter
    than the stores' (n1); P8's 128 and P9's packed 50 as designed."""
    for n in range(1, 129):
        if not smooth7(n):
            with pytest.raises(ValueError):
                dft_matmul.fft_split(n)
            continue
        n1, n2 = dft_matmul.fft_split(n)
        assert n1 * n2 == n and n1 <= n2
        assert n1 in dft_matmul.FFT_SIZES and n2 in dft_matmul.FFT_SIZES
        assert n2 <= (25 if n == 125 else 16)
    assert dft_matmul.fft_split(128) == (8, 16)
    assert dft_matmul.fft_split(50) == (5, 10)
    assert dft_matmul.fft_split(100) == (10, 10)


def test_kernel_instantiates_every_split():
    """``csrc/dft.cu`` has one FFT-body kernel for each split
    ``fft_split`` gives (its ``DFT_FFT_SPLITS`` list), and no other."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "dft.cu").read_text()
    body = src[src.index("#define DFT_FFT_SPLITS(X)"):]
    body = body[:body.index("\n\n")]
    listed = [tuple(map(int, m)) for m in
              re.findall(r"X\((\d+), (\d+)\)", body)]
    want = [dft_matmul.fft_split(n) for n in range(1, 129)
            if smooth7(n)]
    assert listed == want


def test_reg_fft_is_the_dft_at_every_register_size():
    """The plain model of the kernel's register FFT (its DIF steps and
    their output order) against numpy at every size a lane holds."""
    for m in dft_matmul.FFT_SIZES:
        roots = torch.from_numpy(np.exp(-2j * np.pi * np.arange(m) / m))
        x = rand_c((4, m), "double", seed=m)
        got = ref.reg_fft(torch.from_numpy(x), roots, 1)
        assert rel_l2(got.numpy(), np.fft.fft(x)) <= TOL["double"], m


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 16), dtype=torch.complex64)
    with pytest.raises(ValueError, match="caps at n=128"):
        ops.dft(torch.zeros((2, 129), dtype=torch.complex64))
    with pytest.raises(ValueError, match="table does not match"):
        ops.dft(x, matrix=ops.make_matrix(8, False, torch.complex64, "cpu"))
    odd = torch.from_numpy(rand_c((4, 13), "float", seed=13))
    with pytest.raises(ValueError, match="table does not match"):
        ops.dft(odd, matrix=ops.make_matrix(13, False, torch.complex128,
                                            "cpu"))
    # the chirp body's table serves both directions too
    y = ops.dft(odd, inverse=True,
                matrix=ops.make_matrix(13, False, torch.complex64, "cpu"))
    assert torch.equal(y, ops.dft(odd, inverse=True))
    with pytest.raises(ValueError, match="table does not match"):
        ops.dft(x, matrix=ops.make_matrix(16, False, torch.complex128, "cpu"))
    y = ops.dft(x, matrix=ops.make_matrix(16, False, torch.complex64, "cpu"))
    assert torch.equal(y, torch.zeros_like(x))
    # the FFT body's roots serve both directions
    y = ops.dft(x, inverse=True,
                matrix=ops.make_matrix(16, False, torch.complex64, "cpu"))
    assert torch.equal(y, torch.zeros_like(x))


def test_launch_geometry_fills_the_block_within_shared_memory():
    """Both bodies give each of a block's warps a few rows in a padded
    slice (the chirp body's of m = m1 * m2 points a row).  A tile of rows
    never exceeds the batch or one block's 227 KB, and tile 1 always
    fits."""
    for n in NS + (11, 19, 50, 67, 125):
        for itemsize in (8, 16):
            tile = ops.default_tile_b(n, 1 << 20, itemsize)
            n1, n2 = dft_matmul.split(n)
            if smooth7(n):
                assert (n1, n2) == dft_matmul.fft_split(n)
                rpw = dft_matmul.rows_per_warp(n1, n2, itemsize)
                assert rpw * rs_of(n, rpw, itemsize) * itemsize <= \
                    dft_matmul.SLICE_BYTES + rpw * 16 * itemsize or rpw == 1
            else:
                assert (n1, n2) == dft_matmul.chirp_split(n)
                rpw = dft_matmul.chirp_rows_per_warp(n)
                assert rpw == max(1, min(32, 512 // (n1 * n2)))
            assert tile == dft_matmul.FFT_WARPS * rpw
            _, _, got_rpw, pitch, rs = dft_matmul.fft_geometry(
                n, tile, itemsize)
            assert got_rpw == rpw and pitch >= n2 and rs >= n1 * pitch
            assert dft_matmul.fft_smem_bytes(n, tile, itemsize) \
                <= ops.SMEM_LIMIT_BYTES
            assert dft_matmul.fft_smem_bytes(n, 1, itemsize) \
                <= ops.SMEM_LIMIT_BYTES
            assert ops.default_tile_b(n, 3, itemsize) == 3
    # P8: 8 x 16, four rows a warp (64 pass-1 and 32 pass-2 tasks)
    assert dft_matmul.rows_per_warp(8, 16, 8) == 4
    # n = 127 (m = 16 x 16): two rows a warp fill its lanes in both
    # dtypes; P15's n = 19 (m = 5 x 8): twelve
    assert ops.default_tile_b(127, 1 << 20, 8) == 8
    assert ops.default_tile_b(127, 1 << 20, 16) == 8
    assert ops.default_tile_b(19, 1 << 22, 8) == 48


def rs_of(n, rpw, itemsize):
    """The row stride of a warp's slice at ``rpw`` rows."""
    return dft_matmul.slice_layout(*dft_matmul.split(n), rpw, itemsize)[1]


def test_kernel_instantiates_every_chirp_split():
    """``csrc/dft.cu`` has one chirp-body kernel for each split
    ``chirp_split`` gives (its ``DFT_CHIRP_SPLITS`` list, in the order of
    n), and no other."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "dft.cu").read_text()
    body = src[src.index("#define DFT_CHIRP_SPLITS(X)"):]
    body = body[:body.index("\n\n")]
    listed = [tuple(map(int, m)) for m in
              re.findall(r"X\((\d+), (\d+)\)", body)]
    want = []
    for n in range(1, 129):
        if not smooth7(n) and dft_matmul.chirp_split(n) not in want:
            want.append(dft_matmul.chirp_split(n))
    assert listed == want
