"""The port's four-step kernel module against the reference Pallas kernel.

Inputs come from a seeded numpy generator and go through both packages:
the reference's ``fft4step`` runs in Pallas interpret mode, the port's
``ops.fft`` on a CPU tensor takes the plain version of the split's body
(``ref.apply_fourstep_fft``, the FFT body's register passes, where both
sides are 7-smooth; ``ref.apply_fourstep``, the product body's, where
not), fed the reference's own W1/W2/T planes
(``tables_from_reference``) and the kernel's root vector.

Tolerance: rel-L2 <= 1e-5 in float, <= 1e-12 in double against the
reference's kernel (the same split and tables, only the summation order
differs); against numpy the suite's bar, 1e-3 and 1e-8.
"""

import re

import numpy as np
import pytest
import torch

from helpers.accuracy import REL_L2_TOL, rel_l2

from repro.fft import reference as ref_tables
from repro.kernels.fft4step import ops as ref_ops
from repro_torch.fft import reference as port_tables
from repro_torch.kernels import _build
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
    """Each launch of the two-launch form holds a power-of-two tile within
    half a block's shared memory (two blocks an SM): in the FFT body (both
    sides 7-smooth) a tile from 8 columns or rows up, its plane at the
    odd pitch, and the next power of two over half a block or past the
    side; in the product body (128 x 127) a power-of-two count of
    panels."""
    half = ops.SMEM_LIMIT_BYTES // 2
    for n in (13824, 14000, 16384, 128 * 125, 128 * 127):
        n1, n2 = ops.choose_factors(n)
        assert not ops.one_block(n1, n2, 16)
        cols, rows = ops.pass_tiles(n1, n2, 16)
        if fs.fft_body(n1, n2):
            for tile, side, smem in (
                    (cols, n2, lambda t: fs.fft_smem_bytes(n1, t | 1, 16)),
                    (rows, n1, lambda t: fs.fft_smem_bytes(t, n2 | 1, 16))):
                assert tile >= 8 and tile & (tile - 1) == 0, n
                assert smem(tile) <= half, n
                assert tile >= side or smem(2 * tile) > half, n
            assert fs.fft_pitch(cols, n1, 16) == cols | 1
            assert fs.fft_pitch(n2, rows, 16) == n2 | 1
        else:
            panel = 8 * fs.n_tiles(n1, n2)
            for tile, plane in ((cols, n1 * fs.plane_pitch(cols)),
                                (rows, rows * fs.plane_pitch(n2))):
                assert tile % panel == 0 and \
                    (tile // panel) & (tile // panel - 1) == 0, n
                assert fs.product_smem_bytes(n1, n2, 0, 16) + plane * 16 \
                    <= half, n
    assert not fs.fft_body(*ops.choose_factors(128 * 127))
    assert ops.pass_tiles(128, 128, 16) == (32, 32)


#: every split the reference's rule gives up to the cap, by body
SPLITS = sorted({ops.choose_factors(n) for n in range(2, 128 * 128 + 1)
                 if ops.feasible(n, torch.complex64)})
FFT_SPLITS = [s for s in SPLITS if fs.fft_body(*s)]


def _smooth7(m: int) -> bool:
    for p in (2, 3, 5, 7):
        while m % p == 0:
            m //= p
    return m == 1


def test_body_choice_is_seven_smoothness():
    """The FFT body exactly where both sides are 7-smooth; ``ops.plain``
    takes that body's model, and the product body's elsewhere (19 x 19,
    ESTIMATE's pick at P14)."""
    for n1, n2 in SPLITS:
        assert fs.fft_body(n1, n2) == (_smooth7(n1) and _smooth7(n2))
    assert fs.fft_body(*ops.choose_factors(4096))
    assert fs.fft_body(*ops.choose_factors(945))
    assert not fs.fft_body(*ops.choose_factors(361))
    assert not fs.fft_body(*ops.choose_factors(128 * 127))
    x = torch.from_numpy(rand_c((2, 361), "float", seed=361))
    t = ops.make_tables(361, False, torch.complex64, "cpu")
    assert torch.equal(ops.plain(x, t, False),
                       ref.apply_fourstep(x, t.w1, t.w2, t.t))


def test_side_radices_cover_every_side():
    """Every side of an FFT-body split runs as one to three register
    passes whose radices multiply to it; a side of at most 16 points that
    is a register size is one pass; 64 = 8 x 8 and 128 = 16 x 8."""
    for m in sorted({m for s in FFT_SPLITS for m in s}):
        r = fs.side_radices(m)
        assert 1 <= len(r) <= fs.MAX_PASSES and int(np.prod(r)) == m, m
        assert set(r) <= set(fs.FFT_RADICES), m
        if m in fs.FFT_RADICES:
            assert r == (m,)
    assert fs.side_radices(64) == (8, 8)
    assert fs.side_radices(128) == (16, 8)
    assert fs.side_radices(125) == (5, 5, 5)


def test_kernel_instantiates_every_radix():
    """``csrc/fft4step.cu``'s ``FFT4_RADICES`` (the cases of each pass's
    switch) are ``FFT_RADICES``, and every radix the host can ask for is
    one of them; its pass and thread constants are the host's."""
    src = (_build.CSRC / "fft4step.cu").read_text()
    body = src[src.index("#define FFT4_RADICES(X)"):]
    body = body[:body.index("\n\n")]
    listed = tuple(int(m) for m in re.findall(r"X\((\d+)\)", body))
    assert listed == fs.FFT_RADICES
    asked = {f for s in FFT_SPLITS for m in s for f in fs.side_radices(m)}
    assert asked <= set(listed)
    for name, value in (("kSidePasses", fs.MAX_PASSES),
                        ("kFftThreads", fs.FFT_THREADS),
                        ("kFftWideThreads", fs.FFT_WIDE_THREADS),
                        ("kFftMinBlocksF", fs.FFT_MIN_BLOCKS[8]),
                        ("kFftMinBlocksD", fs.FFT_MIN_BLOCKS[16]),
                        ("kFftRoots", None)):
        m = re.search(rf"constexpr int {name} = ([^;]+);", src)
        assert m, name
        if value is not None:
            assert int(m.group(1)) == value, name
    assert "4 * 128" in re.search(r"constexpr int kFftRoots = ([^;]+);",
                                  src).group(1)
    assert fs.FFT_ROOTS == 4 * 128


@pytest.mark.parametrize("chunk", range(4))
def test_fft_body_plain_matches_product_plain_at_every_split(chunk):
    """The FFT body's plain model (register passes, T from its two root
    tables, the digit-reversed store) against the product body's plain
    version on the same plan, at every 7-smooth split up to 16384, on
    two complex128 rows (a quarter of the splits per case), the forward
    and the inverse at every other split."""
    rng = np.random.default_rng(chunk)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # hundreds of small products: one thread
    try:
        for i, (n1, n2) in enumerate(FFT_SPLITS[chunk::4]):
            n = n1 * n2
            inverse = i % 2 == 1
            x = torch.from_numpy(rng.standard_normal((2, n))
                                 + 1j * rng.standard_normal((2, n)))
            t = ops.make_tables(n, inverse, torch.complex128, "cpu")
            got = ref.apply_fourstep_fft(x, t.roots, n1, n2, inverse)
            want = ref.apply_fourstep(x, t.w1, t.w2, t.t)
            want = want / n if inverse else want
            assert rel_l2(got.numpy(), want.numpy()) <= TOL["double"], \
                (n1, n2, inverse)
    finally:
        torch.set_num_threads(threads)


def test_frequencies_are_the_digit_reversal():
    """The frequency at each position after a side's passes: a
    permutation, the identity for one pass, and for 64 = 8 x 8 position
    8 a + b holding frequency a + 8 b."""
    for m in (1, 7, 16, 27, 64, 100, 125, 128):
        f = ref.frequencies(m)
        assert sorted(f) == list(range(m))
        if len(fs.side_radices(m)) == 1:
            assert list(f) == list(range(m))
    f = ref.frequencies(64)
    assert all(f[8 * a + b] == a + 8 * b for a in range(8) for b in range(8))


def test_pair_store_partner_holds_the_next_frequency():
    """The rule of the pair stores that ``profile_fourstep.py`` builds
    into a variant of the row pass: on a side of m points, m a multiple of
    32, whose first radix f0 is even and d = m / f0 a power of two under
    32, position r holds an even frequency exactly where bit d of r is
    clear, and r ^ d holds the next one; P3's, P10's to P12's and D1's n1
    sides (64, 128) are such."""
    sides = [m for m in range(32, 129, 32) if _smooth7(m)]
    used = []
    for m in sides:
        f0 = fs.side_radices(m)[0]
        d = m // f0
        if f0 % 2 or d >= 32 or d & (d - 1):
            continue
        used.append(m)
        f = ref.frequencies(m)
        r = np.arange(m)
        assert ((f % 2 == 0) == ((r & d) == 0)).all(), m
        assert (f[r ^ d] == f ^ 1).all(), m
    assert {64, 128} <= set(used)


@pytest.mark.parametrize("precision", ["float", "double"])
def test_fft_body_tiles_fit(precision):
    """The FFT body's default tile fits one block at every split (its
    plane at ``fft_pitch``), and ``FFT_MIN_BLOCKS`` of them an SM unless
    it is one signal; every tile the product body's plane fits fits it
    too (``one_block`` and the planner's tiles hold for both bodies); at
    P3, P5, P7, P4's packed axis and the long sides it is the card's
    fastest tile or next to it."""
    itemsize = 8 if precision == "float" else 16
    per_sm = fs.SM_SMEM_BYTES // fs.FFT_MIN_BLOCKS[itemsize] - 1024
    for n1, n2 in FFT_SPLITS:
        if not ops.one_block(n1, n2, itemsize):
            continue
        tile = ops.default_tile_b(n1, n2, 1 << 20, itemsize)
        assert 1 <= tile <= fs.MAX_TILE_B
        assert fs.smem_bytes(n1, n2, tile, itemsize) <= ops.SMEM_LIMIT_BYTES
        assert tile == 1 or fs.smem_bytes(n1, n2, tile, itemsize) <= per_sm
        assert ops.default_tile_b(n1, n2, 3, itemsize) <= 3
        for t in (1, 8, 16, tile):
            if fs.product_smem_bytes(n1, n2, t, itemsize) \
                    <= ops.SMEM_LIMIT_BYTES:
                assert fs.smem_bytes(n1, n2, t, itemsize) \
                    <= ops.SMEM_LIMIT_BYTES
    want = ({(4096, 16384): 2, (945, 65536): 9, (16384, 4096): 1,
             (8192, 8192): 1, (1536, 3072): 1}
            if itemsize == 8 else {(64, 524288): 64})
    for (n, rows), tile in want.items():
        assert ops.default_tile_b(*ops.choose_factors(n), rows,
                                  itemsize) == tile, n
    assert fs.fft_threads(128, 128, 1, 8) == fs.FFT_WIDE_THREADS
    assert fs.fft_threads(64, 64, 2, 8) == fs.FFT_THREADS


@pytest.mark.parametrize("n,rows,itemsize", [(4096, 16384, 8),
                                              (945, 65536, 8),
                                              (64, 524288, 16)])
def test_fft_body_tile_follows_the_card(n, rows, itemsize):
    """The default tile is planned for the device's SMs and shared memory
    (``card_shape``): the H100 SXM's for a CPU tensor or no device; more
    SMs leave each block fewer signals of the same batch, less shared
    memory an SM fewer signals a block, and the tile stays at least
    one."""
    n1, n2 = ops.choose_factors(n)
    h100 = (fs.CARD_SMS, fs.SM_SMEM_BYTES)
    assert ops.card_shape(None) == h100
    assert ops.card_shape(torch.device("cpu")) == h100
    tile = ops.default_tile_b(n1, n2, rows, itemsize)
    assert tile == ops.default_tile_b(n1, n2, rows, itemsize,
                                      torch.device("cpu"))
    assert tile == fs.fft_tile_b(n1, n2, rows, itemsize, *h100)
    many = fs.fft_tile_b(n1, n2, rows, itemsize, 8 * fs.CARD_SMS,
                         fs.SM_SMEM_BYTES)
    small = fs.fft_tile_b(n1, n2, rows, itemsize, fs.CARD_SMS,
                          fs.SM_SMEM_BYTES // 4)
    assert 1 <= many <= tile and 1 <= small <= tile
    assert many < tile or tile == 1
    per_sm = fs.FFT_MIN_BLOCKS[itemsize]
    assert small == 1 or fs.smem_bytes(n1, n2, small, itemsize) \
        <= fs.SM_SMEM_BYTES // 4 // per_sm - 1024


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
# exact one (tile 1); square, ragged-split and radix357 lengths up to
# P3's 4096 (the FFT body's plain model), and 361 = 19 x 19 (the product
# body's)
CASES = [(4, 2), (12, 8), (60, 2), (100, 1), (256, 2), (361, 2), (945, 8),
         (1024, 2), (4096, 1)]


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
