"""The Stockham column pass (``csrc/stockham_columns.cuh``) on the CPU.

* The kernel's index model ``ref.run_columns`` (what ``ops.column_pass``
  runs on a CPU tensor: tiles of adjacent columns, FastDiv, the strided
  first load, the padded layouts between the register passes, the
  twiddled and, for pass 1, transposed last store with ``group`` /
  ``out_small``) through ``ops.run_two_pass`` at the lengths over one
  block's cap that ``chip_smoke.py`` checks on the card, and through the
  fused rank-2 kernel's column form (``fft2_pallas.ops._columns``), held
  against the plain version (``ref.apply_two_pass``, ``fft2_pallas``'s
  ``plain``), numpy, and the reference's Pallas kernels in interpret mode.
* The host plan: ``column_schedule``, ``block.column_layout`` (families,
  threads, buffers, the bank model's pads for a transposed store, shared
  memory) and the header's family constants.

Inputs come from a seeded numpy generator.  Tolerance: rel-L2 <= 1e-5 in
float, <= 1e-12 in double against the plain version and numpy (the same
stages and float64-built twiddles, only the summation order and the
register passes' grouping differ); the reference within the suite's
``REL_L2_TOL``, as ``test_two_pass_matches_pallas_interpret`` holds it.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers.accuracy import REL_L2_TOL, rel_l2

from repro.kernels.fft2_pallas import ops as ref_f2
from repro.kernels.stockham_pallas import ops as ref_sp
from repro_torch.kernels.fft2_pallas import ops as f2
from repro_torch.kernels.stockham_pallas import block, ops, ref
from repro_torch.kernels.stockham_pallas.stockham_pallas import (
    radix_schedule, smooth7)

CSRC = Path(ops.__file__).resolve().parents[2] / "csrc"
TOL = {"float": 1e-5, "double": 1e-12}
CDTYPE = {"float": (np.complex64, torch.complex64),
          "double": (np.complex128, torch.complex128)}
ITEM = {"float": 8, "double": 16}

#: ``chip_smoke.py``'s CAPACITY_STOCKHAM: lengths over one block's cap
#: (76545 = 243 x 315, not a power of two; 2^20 at one row)
CAPACITY = [(16384, "float"), (76545, "float"), (1 << 20, "float"),
            (8192, "double"), (65536, "double"), (76545, "double")]


def rand_c(shape, precision, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(CDTYPE[precision][0])


def numpy_fft(x, inverse, axes=(-1,)):
    fn = np.fft.ifftn if inverse else np.fft.fftn
    return fn(x.astype(np.complex128), axes=axes)


@pytest.mark.parametrize("n,precision", CAPACITY)
def test_model_matches_plain_numpy_and_reference(n, precision):
    """Both column passes of an axis over one block's cap, as the kernel
    indexes them, in both directions: the plain version, numpy and the
    reference's one-block kernel in interpret mode."""
    dtype = CDTYPE[precision][1]
    x = rand_c((1, n), precision, seed=n)
    xt = torch.from_numpy(x)
    for inverse in (False, True):
        plan = ops.make_twiddles(n, 8, inverse, dtype, "cpu")
        assert isinstance(plan, ops.TwoPass)
        launches = ops.LAUNCHES
        got = torch.empty_like(xt)
        assert ops.run_two_pass(xt, got, plan, inverse) == 2
        assert ops.LAUNCHES == launches       # a CPU tensor never launches
        plain = ops.plain(xt, plan, inverse)
        plain = plain / n if inverse else plain
        assert rel_l2(got, plain) <= TOL[precision], inverse
        assert rel_l2(got, numpy_fft(x, inverse)) <= TOL[precision], inverse
        want = np.asarray(ref_sp.fft(x, inverse, tile_b=1, interpret=True))
        assert rel_l2(got, want) <= REL_L2_TOL[precision], inverse


def _two_columns(xt, plan, inverse, cols):
    """``ops.run_two_pass``'s two column passes in the kernel's model, at
    a forced tile of ``cols`` columns."""
    n, n1, n2 = plan.n, plan.n1, plan.n2
    rows, item = xt.shape[0], xt.element_size()
    tmp, y = torch.zeros(n * rows, dtype=xt.dtype), torch.zeros_like(xt)
    for src, dst, stages, width, strides, scale in (
            (xt.reshape(-1), tmp, plan.first, n2,
             dict(in_k=n2, out_k=1, out_col=n1, tw_n=n), 1.0),
            (tmp, y.view(-1), plan.second, n1,
             dict(in_k=n1, out_k=n1, out_col=1, tw_n=0),
             1.0 / n if inverse else 1.0)):
        lay = block.column_layout(stages.n, cols, stages.radices,
                                  stages.bases, item, strides["out_k"] == 1)
        ref.run_columns(src, dst, lay, rows, width, stages.tw, plan.roots,
                        inverse, scale, in_sig=n, out_big=n, out_small=0,
                        group=1, tw_q=1, **strides)
    return y


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("cols", [1, 2, 4, 16])
def test_model_at_forced_tiles(cols, precision):
    """Tiles of 1 to 16 columns at forced splits (square and not; a
    ragged last tile where the width is not a multiple; a wide tile over
    a narrow width; the two-buffer fallback of a tile whose middle pass
    outnumbers the threads) against the plain version and numpy."""
    dtype = CDTYPE[precision][1]
    for n, split in ((945, (35, 27)), (945, (27, 35)), (4096, (64, 64)),
                     (60, (4, 15)), (2048, (16, 128))):
        x = rand_c((3, n), precision, seed=n + cols)
        xt = torch.from_numpy(x)
        for inverse in (False, True):
            plan = ops.make_twiddles(n, 8, inverse, dtype, "cpu",
                                     split=split)
            got = _two_columns(xt, plan, inverse, cols)
            plain = ops.plain(xt, plan, inverse)
            plain = plain / n if inverse else plain
            assert rel_l2(got, plain) <= TOL[precision], (n, split, inverse)
            assert rel_l2(got, numpy_fft(x, inverse)) <= TOL[precision]


def _fft2_columns(xt, plan, inverse):
    """The rank-2 kernel's passes over one block's cap: the row pass's
    plain version, then ``_columns`` (the column kernel's model)."""
    sigs, n1, n2 = xt.shape
    rows = ops.plain(xt, plan.rows, inverse)
    rows = rows / n2 if inverse else rows
    got = torch.empty_like(xt)
    launched = f2._columns(rows.contiguous(), got, plan.cols, sigs, n2,
                           inverse)
    return got, launched


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("shape", [(256, 256), (512, 512)])
def test_fft2_column_form(shape, precision):
    """fft2's column pass over its one-block cap (the n1-point columns of
    each n1 x n2 signal, stored in natural order): against fft2's plain
    version, numpy and the reference's fused rank-2 kernel in interpret
    mode."""
    n1, n2 = shape
    dtype = CDTYPE[precision][1]
    x = rand_c((2, n1, n2), precision, seed=n1 * 3 + ITEM[precision])
    xt = torch.from_numpy(x)
    for inverse in (False, True):
        plan = f2.make_twiddles2(n1, n2, 8, inverse, dtype, "cpu")
        assert isinstance(plan, f2.Passes2)
        assert plan.cols.radices == ops.column_schedule(n1, 8, dtype)
        got, launched = _fft2_columns(xt, plan, inverse)
        assert launched == 1
        plain = f2.plain(xt, plan, inverse)
        plain = plain / (n1 * n2) if inverse else plain
        numpy = numpy_fft(x, inverse, axes=(-2, -1))
        assert rel_l2(got, plain) <= TOL[precision], inverse
        assert rel_l2(got, numpy) <= TOL[precision], inverse
        want = np.asarray(ref_f2.fft2(x, inverse, tile_b=1, interpret=True))
        assert rel_l2(got, want) <= REL_L2_TOL[precision], inverse


@pytest.mark.parametrize("precision", ["float", "double"])
def test_fft2_columns_over_the_stockham_cap(precision):
    """A column over the Stockham one-block cap (n1 = a*b) runs the column
    entry twice: the pass twiddle W_n1^(k_a*j_b) (tw_q = n2) and the
    grouped store (group = a, out_small = n2)."""
    n1 = 16384 if precision == "float" else 8192
    n2 = 8
    dtype = CDTYPE[precision][1]
    x = rand_c((2, n1, n2), precision, seed=n1)
    xt = torch.from_numpy(x)
    for inverse in (False, True):
        plan = f2.make_twiddles2(n1, n2, 8, inverse, dtype, "cpu")
        assert isinstance(plan.cols, ops.TwoPass)
        got, launched = _fft2_columns(xt, plan, inverse)
        assert launched == 2
        plain = f2.plain(xt, plan, inverse)
        plain = plain / (n1 * n2) if inverse else plain
        assert rel_l2(got, plain) <= TOL[precision], inverse
        assert rel_l2(got, numpy_fft(x, inverse, axes=(-2, -1))) <= \
            TOL[precision], inverse


def test_column_schedule():
    """At radix 8, complex64 runs a column length's power-of-two stages as
    8x4 pairs, the 32-point pass first (a remainder of 16 as 4x4, else one
    stage), after the odd stages: 1024 points is two passes, one barrier.
    complex128 and other radices keep ``radix_schedule``."""
    c64, c128 = torch.complex64, torch.complex128
    assert ops.column_schedule(1024, 8, c64) == (8, 4, 8, 4)
    assert ops.column_schedule(256, 8, c64) == (8, 4, 8)
    assert ops.column_schedule(512, 8, c64) == (8, 4, 4, 4)
    assert ops.column_schedule(3 * 1024, 8, c64) == (3, 8, 4, 8, 4)
    for n in [m for m in range(2, 14407) if smooth7(m)][::7] + [1 << 13]:
        odd = sorted(r for r in radix_schedule(n, 8) if r % 2)
        for dtype in (c64, c128):
            got = ops.column_schedule(n, 8, dtype)
            assert int(np.prod(got)) == n
            assert sorted(r for r in got if r % 2) == odd
        assert ops.column_schedule(n, 8, c128) == radix_schedule(n, 8)
        for radix in (2, 4):
            for dtype in (c64, c128):
                assert ops.column_schedule(n, radix, dtype) == \
                    radix_schedule(n, radix)
    plan = ops.make_twiddles(1 << 20, 8, False, c64, "cpu")
    lay = ops.column_layout(plan.first, plan.n2, 8, True)
    assert [(p.ra, p.rb) for p in lay.passes] == [(8, 4), (8, 4)]
    assert lay.buffers == 1 and lay.l2 == 16 and lay.threads == 256
    assert lay.family == block.SMALL_POW2 and lay.jfast


@pytest.mark.parametrize("precision", ["float", "double"])
def test_column_layouts_fit_their_kernel(precision):
    """At 7-smooth lengths up to the one-block cap (a sweep), widths
    narrower and wider than a tile and both store orders: every pass a
    case of the column family (no kBig; at most 32 points, 16 in
    complex128), no more threads than the family's column kernel takes,
    an in-place pass no more butterflies than threads, the largest pass
    first where the grouping allows it, shared memory within a block."""
    dtype, item = CDTYPE[precision][1], ITEM[precision]
    most = 32 if item == 8 else 16
    for n in [m for m in range(2, ops.ONE_BLOCK_N[dtype] + 1, 53)
              if smooth7(m)] + [1024, 256, 98, 140]:
        stages = ops.make_twiddles(n, 8, False, dtype, "cpu", columns=True)
        for width, k_fast in ((3, False), (1000, True)):
            lay = ops.column_layout(stages, width, item, k_fast)
            assert lay.family != block.BIG
            assert lay.threads <= block.max_threads(lay.family, item,
                                                    column=True)
            for i, p in enumerate(lay.passes):
                assert block.PASS_CASES.index((p.ra, p.rb)) in \
                    block.family_cases(lay.family, item, False, column=True)
                assert p.R <= most
                if 0 < i < len(lay.passes) - 1 and lay.buffers == 1:
                    assert p.units(n) <= lay.threads
            assert lay.smem <= block.SMEM_LIMIT_BYTES
            if len(lay.passes) == 2 and n & (n - 1) == 0 and item == 8:
                assert lay.passes[0].R >= lay.passes[1].R


def test_transposed_store_is_padded():
    """Pass 1's last pass takes its butterflies fastest (its stores run
    along k); its loads from the buffer then stride by the tile's columns,
    and the bank model pads the layout so that they spread over the
    banks."""
    plan = ops.make_twiddles(1 << 20, 8, False, torch.complex64, "cpu")
    lay = ops.column_layout(plan.first, plan.n2, 8, True)
    writer, reader = lay.passes
    (sh,) = lay.shifts
    assert sh != block.NO_PAD
    unpadded = block._bank_cost(writer, reader, lay.n1, 1, block.NO_PAD, 8,
                                True)
    assert block._bank_cost(writer, reader, lay.n1, 1, sh, 8, True) < unpadded
    loads = block._addresses(reader, lay.n1, 32, False, jfast=True)
    assert (np.diff(loads[0]) == lay.l2).all()      # a warp's butterflies


def test_column_families_match_the_kernel():
    """The host's column families and thread bounds are the header's:
    ``kColumnPow2`` (the 8x4 pass in the complex64 kSmallPow2 family), no
    kBig, and the complex128 families but kSmallPow2 at 64 threads."""
    header = (CSRC / "stockham_columns.cuh").read_text()
    sets = dict(re.findall(
        r"constexpr unsigned long long (kColumn\w+) = bits\(([\d, ]+)\);",
        header))
    parsed = {k: frozenset(int(c) for c in v.split(","))
              for k, v in sets.items()}
    assert parsed == {"kColumnPow2": block._COLUMN_POW2}
    assert "return dbl && family != kSmallPow2 ? 64 : family_threads(" \
        "family, dbl);" in header
    for item in (8, 16):
        assert block.family_cases(block.BIG, item, False, column=True) == \
            frozenset()
        for family in block.FAMILIES:
            one_block = block.family_cases(family, item, False)
            cases = block.family_cases(family, item, False, column=True)
            if family != block.BIG:
                assert one_block <= cases
            want = 64 if item == 16 and family != block.SMALL_POW2 else \
                block.max_threads(family, item)
            assert block.max_threads(family, item, column=True) == want
    assert 23 in block.family_cases(block.SMALL_POW2, 8, False, column=True)
    assert 23 not in block.family_cases(block.SMALL_POW2, 16, False,
                                        column=True)
    # the plan is a kernel parameter: within CUDA's 4 KB
    assert ctypes.sizeof(block.ColumnPlanC) <= 4096


def test_column_struct():
    """``Layout.column_struct``: the tiles of the width, FastDivs of the
    tiles, the group and tw_q, and the layout's passes."""
    stages = ops.make_twiddles(256, 8, False, torch.complex64, "cpu",
                               columns=True)
    lay = ops.column_layout(stages, 100, 8, False)
    cp = lay.column_struct(100, in_sig=25600, in_k=100, out_big=25600,
                           out_small=0, out_k=100, out_col=1, group=3,
                           tw_n=0, tw_q=1)
    assert (cp.width, cp.cols, cp.tiles) == (100, 16, 7)
    assert cp.n_passes == len(lay.passes) and cp.jfast == 0
    assert (cp.f_tiles.d, cp.f_group.d, cp.f_twq.d) == (7, 3, 1)
    for i, p in enumerate(lay.passes):
        d = cp.passes[i]
        assert (d.L, d.C, d.s, d.M) == (p.L, p.C, p.s, p.M)
        assert d.code == block.PASS_CASES.index((p.ra, p.rb))
        assert d.upg == 16 * p.nb
    assert cp.passes[0].in_sh == block.NO_PAD
