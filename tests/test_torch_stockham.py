"""The port's Stockham kernel module against the reference Pallas kernel.

Inputs come from a seeded numpy generator and go through both packages:
the reference's ``stockham_pallas`` runs in Pallas interpret mode, the
port's ``ops.fft`` on a CPU tensor takes the kernel's plain version
(``ref.apply_passes``, the kernel's stages in its register passes) with
the same packed twiddles.

Tolerance: rel-L2 <= 1e-5 in float, <= 1e-12 in double.  Both sides run
the same algorithm (the same radix schedule, the same float64-computed
twiddles cast once), so only the summation order differs.
"""

import numpy as np
import pytest
import torch

from helpers.accuracy import REL_L2_TOL, rel_l2

from repro.kernels.stockham_pallas import ops as sp_ops
from repro.kernels.stockham_pallas.stockham_pallas import (
    radix_schedule as ref_schedule)
from repro_torch.kernels.stockham_pallas import block, ops, ref
from repro_torch.kernels.stockham_pallas.stockham_pallas import (
    radix_schedule, smooth7)

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
    """The cap is the reference's 2^20 in both dtypes.  One block holds
    14406 / 7203 points (two buffers of one row in Hopper's 227 KB of
    shared memory per block); a longer axis runs as two passes."""
    assert ops.MAX_N == {torch.complex64: 1 << 20, torch.complex128: 1 << 20}
    assert ops.ONE_BLOCK_N[torch.complex64] == 14406
    assert ops.ONE_BLOCK_N[torch.complex128] == 7203
    for dtype in (torch.complex64, torch.complex128):
        n = ops.ONE_BLOCK_N[dtype]
        assert ops.smem_bytes(n, 1, 16 if dtype == torch.complex128 else 8,
                              2) <= ops.SMEM_LIMIT_BYTES
        assert isinstance(ops.make_twiddles(n, 8, False, dtype, "cpu"),
                          ops.Twiddles)
        two = ops.make_twiddles(16384, 8, False, dtype, "cpu")
        assert isinstance(two, ops.TwoPass) and (two.n1, two.n2) == (128, 128)
        with pytest.raises(ValueError, match="caps at"):
            ops.fft(torch.zeros((1, 1 << 21), dtype=dtype))
        with pytest.raises(ValueError, match="caps at"):
            ops.make_twiddles(3 << 20, 8, False, dtype, "cpu")
    with pytest.raises(ValueError, match="7-smooth"):
        ops.fft(torch.zeros((1, 97), dtype=torch.complex64))


def test_two_pass_split_fits_one_block_at_every_length():
    """Every 7-smooth length over the one-block cap, up to 2^20, splits
    into two factors that one block holds, the smaller at most sqrt(n);
    each column pass's plan (``column_layout``) fits one block's 227 KB,
    its threads fit its family's column kernel, and its row-run is 128
    bytes unless the width is narrower or twice the columns would not
    fit a block."""
    for dtype, itemsize in ((torch.complex64, 8), (torch.complex128, 16)):
        cap = ops.ONE_BLOCK_N[dtype]
        for n in [m for m in range(cap + 1, (1 << 20) + 1, 97) if smooth7(m)] \
                + [1 << 20, 7 ** 7, 76545]:
            n1, n2 = ops.choose_split(n, dtype)
            assert n1 * n2 == n and 2 <= n1 <= n2 <= cap, (n, dtype)
            assert n1 * n1 <= n
            plan = ops.make_twiddles(n, 8, False, dtype, "cpu")
            for stages, width, k_fast in ((plan.first, n2, True),
                                          (plan.second, n1, False)):
                lay = ops.column_layout(stages, width, itemsize, k_fast)
                cols = lay.l2
                assert 1 <= cols <= 16 and lay.jfast == k_fast
                assert lay.smem <= ops.SMEM_LIMIT_BYTES
                assert lay.threads <= block.max_threads(lay.family, itemsize,
                                                        column=True)
                if cols * itemsize < ops.COLUMN_RUN_BYTES and cols < width:
                    with pytest.raises(ValueError):
                        block.column_layout(stages.n, 2 * cols,
                                            stages.radices, stages.bases,
                                            itemsize, k_fast)
    assert ops.choose_split(1 << 20, torch.complex64) == (1024, 1024)
    assert ops.choose_split(65536, torch.complex128) == (256, 256)
    assert ops.choose_split(76545, torch.complex64) == (243, 315)


# (n, split, reference tile): a power of two and an odd length, split
# square and not
TWO_PASS = [(4096, (64, 64), 2), (945, (35, 27), 2), (945, (27, 35), 1),
            (60, (4, 15), 2)]


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("n,split,tile", TWO_PASS)
def test_two_pass_matches_pallas_interpret(n, split, tile, precision):
    """The two-pass plain version at a forced split against the
    reference's one-block kernel (interpret mode; complex128 at tile 1,
    see test_fft_matches_pallas_interpret) and numpy: the suite's bar, the
    factorization being another."""
    x = rand_c((3, n), precision, seed=n + split[0])
    xt = torch.from_numpy(x)
    dtype = CDTYPE[precision][1]
    if precision == "double":
        tile = 1
    for inverse in (False, True):
        plan = ops.make_twiddles(n, 8, inverse, dtype, "cpu", split=split)
        assert isinstance(plan, ops.TwoPass) and (plan.n1, plan.n2) == split
        launches = ops.LAUNCHES
        got = ops.fft(xt, inverse, twiddles=plan)
        assert ops.LAUNCHES == launches       # a CPU tensor never launches
        want = np.asarray(sp_ops.fft(x, inverse, tile_b=tile, interpret=True))
        numpy = (np.fft.ifft if inverse else np.fft.fft)(
            x.astype(np.complex128))
        assert got.dtype == dtype
        assert rel_l2(got, want) <= REL_L2_TOL[precision], inverse
        assert rel_l2(got, numpy) <= TOL[precision], inverse


@pytest.mark.parametrize("precision", ["float", "double"])
def test_two_pass_over_the_cap_agrees_with_numpy(precision):
    """The default plan of an axis over the one-block cap is two passes
    (16384 = 128 x 128, 76545 = 243 x 315), agreeing with numpy and with
    the independent oracle."""
    dtype = CDTYPE[precision][1]
    for n, rows in ((16384, 2), (76545, 1)):
        x = rand_c((rows, n), precision, seed=n)
        xt = torch.from_numpy(x)
        for inverse in (False, True):
            plan = ops.make_twiddles(n, 8, inverse, dtype, "cpu")
            assert isinstance(plan, ops.TwoPass)
            got = ops.fft(xt, inverse, twiddles=plan)
            numpy = (np.fft.ifft if inverse else np.fft.fft)(
                x.astype(np.complex128))
            assert rel_l2(got, numpy) <= TOL[precision], (n, inverse)
            assert rel_l2(got, ref.stockham_ref(xt, 8, inverse)) <= \
                TOL[precision], (n, inverse)


def test_two_pass_plan_must_match_the_call():
    x = torch.from_numpy(rand_c((2, 60), "float", seed=2))
    plan = ops.make_twiddles(60, 8, False, torch.complex64, "cpu",
                             split=(4, 15))
    assert plan.nbytes == plan.first.nbytes + plan.second.nbytes + \
        plan.roots.numel() * 8
    with pytest.raises(ValueError, match="do not match"):
        ops.fft(x, True, twiddles=plan)           # wrong direction
    with pytest.raises(ValueError, match="do not match"):
        ops.fft(x, radix=2, twiddles=plan)        # wrong schedule
    with pytest.raises(ValueError, match="not a two-pass split"):
        ops.make_twiddles(60, 8, False, torch.complex64, "cpu", split=(6, 9))


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
        for n in (2, 12, 945, 4096, ops.ONE_BLOCK_N[dtype]):
            stages = len(radix_schedule(n, 8))
            tile = ops.default_tile_b(n, 10 ** 6, size, stages)
            assert tile >= 1
            assert ops.smem_bytes(n, tile, size, stages) <= ops.SMEM_LIMIT_BYTES
