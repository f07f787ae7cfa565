"""The port's fused rank-2 kernel module against the reference Pallas kernel.

Inputs come from a seeded numpy generator and go through both packages:
the reference's ``fft2_pallas`` runs in Pallas interpret mode, the port's
``ops.fft2`` on a CPU tensor takes the kernel's plain version
(``ref.apply2_passes``), fed the reference's own twiddle pack
(``twiddles_from_reference``).

Tolerance: rel-L2 <= 1e-5 in float, <= 1e-12 in double against the
reference's kernel (the same schedules and twiddles, only the summation
order differs); against numpy the suite's bar, 1e-3 and 1e-8.
"""

import numpy as np
import pytest
import torch

from helpers.accuracy import REL_L2_TOL, rel_l2

from repro.fft import rfft as ref_rfft
from repro.kernels.fft2_pallas import ops as ref_ops
from repro.kernels.stockham_pallas.stockham_pallas import (
    radix_schedule as ref_schedule)
from repro_torch.fft import rfft as port_rfft
from repro_torch.fft.reference import half_roots
from repro_torch.kernels.fft2_pallas import ops, ref

TOL = {"float": 1e-5, "double": 1e-12}
CDTYPE = {"float": (np.complex64, torch.complex64),
          "double": (np.complex128, torch.complex128)}
REAL = {"float": np.float32, "double": np.float64}


def rand_c(shape, precision, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(CDTYPE[precision][0])


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("inverse", [False, True])
def test_pack_twiddles2_matches_reference(precision, inverse):
    for n1, n2 in ((1, 8), (8, 1), (2, 2), (16, 32), (64, 128), (4096, 2)):
        for radix in (2, 4, 8):
            r1, r2 = ref_schedule(n1, radix), ref_schedule(n2, radix)
            got = ops.pack_twiddles2(n1, n2, r1, r2, inverse, REAL[precision])
            want = ref_ops.pack_twiddles2(n1, n2, r1, r2, inverse,
                                          REAL[precision])
            assert got[2:] == want[2:]
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[0].dtype == want[0].dtype
            # the port's own plan is the reference's pack, uploaded as is
            cdt = CDTYPE[precision][1]
            if n1 * n2 > ops.ONE_BLOCK_ELEMS[cdt]:
                continue
            own = ops.make_twiddles2(n1, n2, radix, inverse, cdt, "cpu")
            carried = ops.twiddles_from_reference(*want, device="cpu")
            assert own.bases1 == carried.bases1 and own.bases2 == carried.bases2
            assert (own.radices1, own.radices2) == (r1, r2)
            assert torch.equal(own.tw, carried.tw)
            assert carried.inverse in (None, inverse)


def test_hopper_cap_and_contract():
    """The cap is the reference's 2^18 points in both dtypes; one block
    holds 8192 / 4096 points and a larger tile runs as passes."""
    assert ops.MAX_ELEMS == {torch.complex64: 1 << 18,
                             torch.complex128: 1 << 18}
    assert ops.ONE_BLOCK_ELEMS == {torch.complex64: 8192,
                                   torch.complex128: 4096}
    for shape, dtype, match in (((1, 1024, 512), torch.complex64, "caps at"),
                                ((1, 512, 1024), torch.complex128, "caps at"),
                                ((1, 8, 12), torch.complex64, "power-of-two"),
                                ((16,), torch.complex64, "rank >= 2")):
        with pytest.raises(ValueError, match=match):
            ops.fft2(torch.zeros(shape, dtype=dtype))
    # real input is cast to complex64, as the reference does at any width
    x = torch.ones((2, 4, 4), dtype=torch.float64)
    assert ops.fft2(x).dtype == torch.complex64
    one = torch.ones((3, 1, 1), dtype=torch.complex128)
    assert ops.fft2(one, inverse=True) is one
    plan = ops.make_twiddles2(16, 16, 8, False, torch.complex64, "cpu")
    with pytest.raises(ValueError, match="do not match"):
        ops.fft2(torch.zeros((1, 16, 16), dtype=torch.complex64), True,
                 twiddles=plan)
    passes = ops.make_twiddles2(128, 128, 8, False, torch.complex64, "cpu")
    assert isinstance(passes, ops.Passes2)
    assert passes.nbytes == passes.rows.nbytes + passes.cols.nbytes
    with pytest.raises(ValueError, match="do not match"):
        ops.fft2(torch.zeros((1, 128, 128), dtype=torch.complex64), True,
                 twiddles=passes)


# tiles over one block: square, long rows (a two-pass row), long columns
# (a two-pass column), an extent of 1 each way
PASSES = [(256, 256, "float"), (64, 128, "double"), (4, 16384, "float"),
          (32768, 2, "double"), (1, 32768, "float"), (16384, 1, "double")]


@pytest.mark.parametrize("n1,n2,precision", PASSES)
def test_passes_agree_with_numpy(n1, n2, precision):
    """Tiles over the one-block cap: the plain version of the row pass and
    the column pass (two passes where an axis is over the Stockham
    one-block cap) against numpy, at the suite's bar and the plain
    versions' tolerance."""
    x = rand_c((2, n1, n2), precision, seed=n1 + n2)
    xt = torch.from_numpy(x)
    dtype = CDTYPE[precision][1]
    for inverse in (False, True):
        plan = ops.make_twiddles2(n1, n2, 8, inverse, dtype, "cpu")
        assert isinstance(plan, ops.Passes2)
        launches = ops.LAUNCHES
        got = ops.fft2(xt, inverse, twiddles=plan)
        assert ops.LAUNCHES == launches       # a CPU tensor never launches
        want = (np.fft.ifft2 if inverse else np.fft.fft2)(
            x.astype(np.complex128))
        assert got.dtype == dtype
        assert rel_l2(got, want) <= TOL[precision], inverse


@pytest.mark.parametrize("precision", ["float", "double"])
def test_passes_match_pallas_interpret(precision):
    """256 x 256 (the backends table's node, over one block in both
    dtypes) against the reference's kernel in interpret mode, at the
    suite's bar."""
    x = rand_c((2, 256, 256), precision, seed=256)
    for inverse in (False, True):
        got = ops.fft2(torch.from_numpy(x), inverse).numpy()
        want = np.asarray(ref_ops.fft2(x, inverse, tile_b=1, interpret=True))
        assert rel_l2(got, want) <= REL_L2_TOL[precision], inverse


# (n1, n2, radix, reference tile): a padded batch (5 in tiles of 2), an
# exact one (tile 1) and the reference's default tile
CASES = [(4, 8, 2, 2), (16, 32, 8, 2), (2, 16, 4, 1), (8, 8, 4, None),
         (1, 16, 8, 2), (16, 1, 2, 2)]


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("n1,n2,radix,tile", CASES)
def test_fft2_matches_pallas_interpret(n1, n2, radix, tile, precision):
    x = rand_c((5, n1, n2), precision, seed=n1 * 100 + n2 + radix)
    xt = torch.from_numpy(x)
    r1, r2 = ref_schedule(n1, radix), ref_schedule(n2, radix)
    want_np = np.fft.fft2(x.astype(np.complex128))
    for inverse in (False, True):
        pack = ref_ops.pack_twiddles2(n1, n2, r1, r2, inverse,
                                      REAL[precision])
        plan = ops.twiddles_from_reference(*pack, device="cpu")
        got = ops.fft2(xt, inverse, radix=radix, twiddles=plan).numpy()
        want = np.asarray(ref_ops.fft2(x, inverse, tile_b=tile, radix=radix,
                                       interpret=True))
        assert got.dtype == want.dtype == x.dtype
        assert rel_l2(got, want) <= TOL[precision], inverse
        numpy = np.fft.ifft2(x.astype(np.complex128)) if inverse else want_np
        assert rel_l2(got, numpy) <= REL_L2_TOL[precision], inverse


@pytest.mark.parametrize("precision", ["float", "double"])
def test_plain_versions_agree_with_numpy(precision):
    """The oracle and the kernel's plain version, across radices and a
    batch with two leading axes."""
    x = rand_c((2, 3, 32, 64), precision, seed=41)
    xt = torch.from_numpy(x)
    for radix in (2, 4, 8):
        for inverse in (False, True):
            want = (np.fft.ifft2 if inverse else np.fft.fft2)(
                x.astype(np.complex128))
            assert rel_l2(ref.fft2_ref(xt, radix, inverse), want) <= \
                TOL[precision]
            assert rel_l2(ops.fft2(xt, inverse, radix=radix), want) <= \
                TOL[precision]


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("n1,n2", [(8, 16), (16, 4), (4, 2)])
def test_rfftn_packed_matches_reference(n1, n2, precision):
    """The packed real path over the fused rank-2 engines of both packages
    (the reference's kernel in interpret mode), both directions."""
    rng = np.random.default_rng(n1 * n2)
    x = rng.standard_normal((3, n1, n2)).astype(REAL[precision])
    cdt = CDTYPE[precision][1]
    h = n2 // 2
    plans = {inv: ops.make_twiddles2(n1, h, 8, inv, cdt, "cpu")
             for inv in (False, True)}
    port_eng = lambda z, inverse=False: ops.fft2(z, inverse,
                                                 twiddles=plans[inverse])
    ref_eng = lambda z, inverse=False: ref_ops.fft2(z, inverse,
                                                    interpret=True)
    roots = half_roots(n2, False, cdt, device="cpu")
    got = port_rfft.rfftn_packed(torch.from_numpy(x), port_eng, 2, roots)
    want = np.asarray(ref_rfft.rfftn_packed(x, ref_eng, rank=2))
    assert got.shape == want.shape
    assert rel_l2(got.numpy(), want) <= TOL[precision]
    assert rel_l2(got.numpy(), np.fft.rfft2(x.astype(np.float64))) <= \
        REL_L2_TOL[precision]
    inv_roots = half_roots(n2, True, cdt, device="cpu")
    back = port_rfft.irfftn_packed(got, (n1, n2), port_eng, inv_roots)
    ref_back = np.asarray(ref_rfft.irfftn_packed(want, (n1, n2), ref_eng))
    assert back.dtype == torch.from_numpy(x).dtype
    assert rel_l2(back.numpy(), ref_back) <= TOL[precision]
    assert rel_l2(back.numpy(), x) <= REL_L2_TOL[precision]


@pytest.mark.parametrize("shape", [(4, 7), (6, 5), (3, 4, 9)])
def test_rfftn_packed_odd_last_extent_matches_reference(shape):
    """Odd last extents take the full complex transform and the Hermitian
    rebuild, exactly as the reference does (any whole-transform engine)."""
    import jax.numpy as jnp

    rank = len(shape)
    axes = tuple(range(-rank, 0))
    x = np.random.default_rng(sum(shape)).standard_normal((2, *shape))
    port_eng = lambda z, inverse=False: (
        torch.fft.ifftn if inverse else torch.fft.fftn)(z, dim=axes)
    ref_eng = lambda z, inverse=False: (
        jnp.fft.ifftn if inverse else jnp.fft.fftn)(z, axes=axes)
    got = port_rfft.rfftn_packed(torch.from_numpy(x), port_eng, rank)
    want = np.asarray(ref_rfft.rfftn_packed(x, ref_eng, rank=rank))
    assert rel_l2(got.numpy(), want) <= TOL["double"]
    back = port_rfft.irfftn_packed(got, shape, port_eng)
    ref_back = np.asarray(ref_rfft.irfftn_packed(want, shape, ref_eng))
    assert rel_l2(back.numpy(), ref_back) <= TOL["double"]
    assert rel_l2(back.numpy(), x) <= TOL["double"]
