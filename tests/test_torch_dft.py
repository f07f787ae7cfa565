"""The port's dft_matmul kernel module against the reference Pallas kernel.

Inputs come from a seeded numpy generator and go through both packages:
the reference's ``ops.dft`` runs its Pallas kernel in interpret mode, the
port's ``ops.dft`` on a CPU tensor takes the kernel's plain version
(``ref.apply_dft``); the two plain oracles (``dft_ref``) are compared on
the same planes.

Tolerance: rel-L2 <= 1e-5 for complex64 and <= 1e-12 for complex128
against the reference: the same table, built in float64 and cast to the
plane dtype, and the same algorithm; only the summation order differs.
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
    np_dtype, dtype = CDTYPE[precision]
    for n in (3, 100, 128):
        for inverse in (False, True):
            m = ops.make_matrix(n, inverse, dtype, "cpu")
            want = np.asarray(ref_tables.dft_matrix(n, inverse, jnp.complex128)
                              ).astype(np_dtype)
            assert np.array_equal(m.w.numpy(), want)
            assert m.nbytes == n * n * np.dtype(np_dtype).itemsize
    assert ops.make_matrix(2, True, dtype, "cpu").inverse is None


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 16), dtype=torch.complex64)
    with pytest.raises(ValueError, match="caps at n=128"):
        ops.dft(torch.zeros((2, 129), dtype=torch.complex64))
    with pytest.raises(ValueError, match="table does not match"):
        ops.dft(x, matrix=ops.make_matrix(8, False, torch.complex64, "cpu"))
    with pytest.raises(ValueError, match="table does not match"):
        ops.dft(x, inverse=True,
                matrix=ops.make_matrix(16, False, torch.complex64, "cpu"))
    with pytest.raises(ValueError, match="table does not match"):
        ops.dft(x, matrix=ops.make_matrix(16, False, torch.complex128, "cpu"))
    y = ops.dft(x, matrix=ops.make_matrix(16, False, torch.complex64, "cpu"))
    assert torch.equal(y, torch.zeros_like(x))


def test_launch_geometry_fills_the_block_within_shared_memory():
    """Each thread gets a 4x4 register tile; a tile of rows never exceeds
    the batch or one block's 227 KB, and tile 1 always fits."""
    for n in NS:
        for itemsize in (8, 16):
            tile = ops.default_tile_b(n, 1 << 20, itemsize)
            assert tile == dft_matmul.fill_rows(n)
            assert dft_matmul.smem_bytes(n, tile, itemsize) \
                <= ops.SMEM_LIMIT_BYTES
            groups = -(-tile // 4) * -(-n // 4)
            assert groups <= dft_matmul.THREADS
            assert ops.default_tile_b(n, 3, itemsize) == 3
    assert dft_matmul.smem_bytes(128, 1, 16) <= ops.SMEM_LIMIT_BYTES
