"""The port's Stockham kernel module against the reference Pallas kernel.

Inputs come from a seeded numpy generator and go through both packages:
the reference's ``stockham_pallas`` runs in Pallas interpret mode, the
port's ``ops.fft`` on a CPU tensor takes the kernel's plain version
(``ref.apply_stages``) with the same packed twiddles.

Tolerance: rel-L2 <= 1e-5 in float, <= 1e-12 in double.  Both sides run
the same algorithm (the same radix schedule, the same float64-computed
twiddles cast once), so only the summation order differs.
"""

import numpy as np
import pytest
import torch

from helpers.accuracy import rel_l2

from repro.kernels.stockham_pallas import ops as sp_ops
from repro.kernels.stockham_pallas.stockham_pallas import (
    radix_schedule as ref_schedule)
from repro_torch.kernels.stockham_pallas import ops, ref
from repro_torch.kernels.stockham_pallas.stockham_pallas import radix_schedule

TOL = {"float": 1e-5, "double": 1e-12}
CDTYPE = {"float": (np.complex64, torch.complex64),
          "double": (np.complex128, torch.complex128)}


def rand_c(shape, precision, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(CDTYPE[precision][0])


@pytest.mark.parametrize("radix", [2, 4, 8])
def test_radix_schedule_matches_reference(radix):
    for n in list(range(1, 400)) + [945, 1024, 3072, 4096, 14406, 1 << 20]:
        try:
            want = ref_schedule(n, radix)
        except ValueError:
            with pytest.raises(ValueError):
                radix_schedule(n, radix)
            continue
        assert radix_schedule(n, radix) == want, n
    with pytest.raises(ValueError):
        radix_schedule(64, 16)


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("inverse", [False, True])
def test_pack_twiddles_matches_reference(precision, inverse):
    real = np.float32 if precision == "float" else np.float64
    for n in (2, 3, 12, 100, 945, 1024, 3072, 14406):
        for radix in (2, 4, 8):
            sched = radix_schedule(n, radix)
            got = ops.pack_twiddles(n, sched, inverse, real)
            want = sp_ops.pack_twiddles(n, sched, inverse, real)
            assert got[2] == want[2]
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[0].dtype == want[0].dtype


# n=2 and n=3 have one stage whatever the radix: one radix covers them
CASES = [(n, r) for n in (12, 100, 945, 1024) for r in (2, 4, 8)] \
    + [(2, 8), (3, 8)]


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("n,radix", CASES)
def test_fft_matches_pallas_interpret(n, radix, precision):
    """Forward and inverse on a ragged batch (5 rows; reference tile 2).

    The reference runs complex128 at tile 1: in interpret mode its
    complex128 output is wrong at n=100 (and n=60) for any tile of two or
    more rows (rel-L2 ~0.3 against numpy, while its own jnp oracle agrees
    with numpy), a fault of the reference recorded in ROADMAP.md."""
    x = rand_c((5, n), precision, seed=n * 10 + radix)
    xt = torch.from_numpy(x)
    tile = 2 if precision == "float" else 1
    for inverse in (False, True):
        want = np.asarray(sp_ops.fft(x, inverse, tile_b=tile, radix=radix,
                                     interpret=True))
        got = ops.fft(xt, inverse, radix=radix)
        oracle = ref.stockham_ref(xt, radix, inverse)
        assert got.dtype == CDTYPE[precision][1]
        assert rel_l2(got, want) <= TOL[precision], (n, radix, inverse)
        assert rel_l2(oracle, want) <= TOL[precision], (n, radix, inverse)


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("n,radix", [(12, 8), (945, 8), (1024, 4), (3, 2)])
def test_twiddles_from_reference(n, radix, precision):
    """The reference's own pack_twiddles output becomes the same device
    plan as the port's, and gives identical transforms."""
    real = np.float32 if precision == "float" else np.float64
    x = torch.from_numpy(rand_c((3, n), precision, seed=n))
    for inverse in (False, True):
        sched = ref_schedule(n, radix)
        twr, twi, offsets = sp_ops.pack_twiddles(n, sched, inverse, real)
        conv = ops.twiddles_from_reference(twr, twi, offsets, "cpu")
        own = ops.make_twiddles(n, radix, inverse, CDTYPE[precision][1], "cpu")
        assert conv.radices == own.radices == sched
        assert conv.bases == own.bases == tuple(o[0] for o in offsets)
        assert conv.inverse == own.inverse
        assert torch.equal(conv.tw, own.tw)
        assert torch.equal(ops.fft(x, inverse, radix=radix, twiddles=conv),
                           ops.fft(x, inverse, radix=radix))


def test_twiddles_must_match_the_call():
    x = torch.from_numpy(rand_c((2, 12), "float", seed=1))
    fwd = ops.make_twiddles(12, 8, False, torch.complex64, "cpu")
    with pytest.raises(ValueError):
        ops.fft(x, True, twiddles=fwd)            # wrong direction
    with pytest.raises(ValueError):
        ops.fft(x, radix=2, twiddles=fwd)         # wrong schedule
    with pytest.raises(ValueError):
        ops.fft(x.to(torch.complex128), twiddles=fwd)  # wrong dtype


def test_hopper_cap_raises():
    """The cap comes from Hopper's 227 KB of shared memory per block
    (two buffers of one row), not from the TPU's VMEM."""
    assert ops.MAX_N[torch.complex64] == 14406
    assert ops.MAX_N[torch.complex128] == 7203
    for dtype in (torch.complex64, torch.complex128):
        n = ops.MAX_N[dtype]
        assert ops.smem_bytes(n, 1, 16 if dtype == torch.complex128 else 8,
                              2) <= ops.SMEM_LIMIT_BYTES
        with pytest.raises(ValueError, match="caps at"):
            ops.fft(torch.zeros((1, 16384), dtype=dtype))
        with pytest.raises(ValueError, match="caps at"):
            ops.make_twiddles(16384, 8, False, dtype, "cpu")
    with pytest.raises(ValueError, match="7-smooth"):
        ops.fft(torch.zeros((1, 97), dtype=torch.complex64))


def test_real_input_and_length_one():
    """Real input is cast to complex64 at any width (as the reference
    wrapper does); a length-1 transform is the identity."""
    x = np.random.default_rng(3).standard_normal((4, 12))
    got = ops.fft(torch.from_numpy(x))
    assert got.dtype == torch.complex64
    assert rel_l2(got, np.fft.fft(x)) <= 1e-5
    one = torch.ones((3, 1), dtype=torch.complex128)
    assert torch.equal(ops.fft(one, True), one)


def test_default_tile_fits_shared_memory():
    for dtype, size in ((torch.complex64, 8), (torch.complex128, 16)):
        for n in (2, 12, 945, 4096, ops.MAX_N[dtype]):
            stages = len(radix_schedule(n, 8))
            tile = ops.default_tile_b(n, 10 ** 6, size, stages)
            assert tile >= 1
            assert ops.smem_bytes(n, tile, size, stages) <= ops.SMEM_LIMIT_BYTES
