"""The port's dft_matmul kernel module against the reference Pallas kernel.

Inputs come from a seeded numpy generator and go through both packages:
the reference's ``ops.dft`` runs its Pallas kernel in interpret mode, the
port's ``ops.dft`` on a CPU tensor takes the kernel's plain version
(``ref.apply_fft`` for a 7-smooth n, ``ref.apply_dft`` for any other);
the two plain oracles (``dft_ref``) are compared on the same planes.

Tolerance: rel-L2 <= 1e-5 for complex64 and <= 1e-12 for complex128
against the reference and numpy: the same DFT from tables built in
float64 and cast to the plane dtype; the direct product differs from the
reference's only in summation order, the FFT in its factorization, whose
rounding (~log n ulps) stays well inside these bars.
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
    the reference's forward table), one table for both directions; any
    other n's is the reference's n x n table of its direction."""
    np_dtype, dtype = CDTYPE[precision]
    for n in (3, 100, 127, 128):
        for inverse in (False, True):
            m = ops.make_matrix(n, inverse, dtype, "cpu")
            smooth = n != 127
            want = np.asarray(ref_tables.dft_matrix(
                n, inverse and not smooth, jnp.complex128)).astype(np_dtype)
            assert m.fft == smooth
            if smooth:
                assert np.array_equal(m.w.numpy(), want[1])
                assert m.inverse is None
                assert m.nbytes == n * np.dtype(np_dtype).itemsize
            else:
                assert np.array_equal(m.w.numpy(), want)
                assert m.inverse is inverse
                assert m.nbytes == n * n * np.dtype(np_dtype).itemsize
    assert ops.make_matrix(2, True, dtype, "cpu").inverse is None


#: The FFT body's lengths (powers of two, 12, 50 = 5 x 10, 60, 100 =
#: 10 x 10, 105 = 7 x 15) and the direct product's (11, 97, 127).
REFERENCE_NS = (2, 8, 12, 50, 60, 64, 100, 105, 128, 11, 97, 127)


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
    version on its split (7-smooth n), the direct product's on the rest."""
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
    odd = torch.zeros((4, 13), dtype=torch.complex64)
    with pytest.raises(ValueError, match="table does not match"):
        ops.dft(odd, inverse=True,       # the direct product's direction
                matrix=ops.make_matrix(13, False, torch.complex64, "cpu"))
    with pytest.raises(ValueError, match="table does not match"):
        ops.dft(x, matrix=ops.make_matrix(16, False, torch.complex128, "cpu"))
    y = ops.dft(x, matrix=ops.make_matrix(16, False, torch.complex64, "cpu"))
    assert torch.equal(y, torch.zeros_like(x))
    # the FFT body's roots serve both directions
    y = ops.dft(x, inverse=True,
                matrix=ops.make_matrix(16, False, torch.complex64, "cpu"))
    assert torch.equal(y, torch.zeros_like(x))


def test_launch_geometry_fills_the_block_within_shared_memory():
    """The direct product gives each thread a 4x4 register tile; the FFT
    body gives each of its warps a few rows in a padded slice.  A tile of
    rows never exceeds the batch or one block's 227 KB, and tile 1 always
    fits."""
    for n in NS + (50, 125):
        for itemsize in (8, 16):
            tile = ops.default_tile_b(n, 1 << 20, itemsize)
            if smooth7(n):
                n1, n2 = dft_matmul.fft_split(n)
                rpw = dft_matmul.rows_per_warp(n1, n2, itemsize)
                assert tile == dft_matmul.FFT_WARPS * rpw
                _, _, got_rpw, pitch, rs = dft_matmul.fft_geometry(
                    n, tile, itemsize)
                assert got_rpw == rpw and pitch >= n2 and rs >= n1 * pitch
                assert rpw * rs * itemsize <= dft_matmul.SLICE_BYTES \
                    + rpw * 16 * itemsize
                assert dft_matmul.fft_smem_bytes(n, tile, itemsize) \
                    <= ops.SMEM_LIMIT_BYTES
                assert dft_matmul.fft_smem_bytes(n, 1, itemsize) \
                    <= ops.SMEM_LIMIT_BYTES
            else:
                assert tile == dft_matmul.fill_rows(n)
                assert dft_matmul.smem_bytes(n, tile, itemsize) \
                    <= ops.SMEM_LIMIT_BYTES
                groups = -(-tile // 4) * -(-n // 4)
                assert groups <= dft_matmul.THREADS
            assert ops.default_tile_b(n, 3, itemsize) == 3
    assert dft_matmul.smem_bytes(127, 1, 16) <= ops.SMEM_LIMIT_BYTES
    # P8: 8 x 16, four rows a warp (64 pass-1 and 32 pass-2 tasks)
    assert dft_matmul.rows_per_warp(8, 16, 8) == 4
