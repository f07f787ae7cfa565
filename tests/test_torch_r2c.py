"""The one-block kernels' register passes and real-input folds, on the CPU.

* The new wrappers ``stockham_pallas.ops.rfft`` / ``irfft`` and
  ``fft2_pallas.ops.rfft2`` / ``irfft2`` (on a CPU tensor: ``fft/rfft.py``'s
  packing around the plain stages) against the reference's
  ``repro.fft.rfft.rfft`` / ``irfft`` / ``rfftn_packed`` / ``irfftn_packed``
  over its Pallas kernels in interpret mode (complex128 at tile 1, which
  avoids the reference's interpret-mode fault at n = 60 / 100, ROADMAP.md
  section 3 fault 1).
* The plain models of the kernel: ``ref.apply_passes`` (the pass grouping
  of ``block.group_passes``) and ``ref.run_block`` (the kernel's own work
  units, FastDiv, padded layouts and the folds' paired butterflies: the
  R2C post-pass and the C2R pre-pass), over every 7-smooth n up to 512
  and at the P1 / P4 / P5 / P6 engine shapes scaled down, against
  ``ref.apply_stages`` and numpy.
* The host plan: the pass table against the CUDA header, FastDiv, the
  layouts' registers, threads, buffers, pads and shared memory.
* Which entries the clients call on a real kind.

Inputs come from a seeded numpy generator.  Tolerance: rel-L2 <= 1e-5 in
float, <= 1e-12 in double (the same algorithm and twiddles on both sides,
only the summation order differs).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers.accuracy import rel_l2

from repro.fft import rfft as ref_rfft
from repro.kernels.fft2_pallas import ops as ref_f2
from repro.kernels.stockham_pallas import ops as ref_sp
from repro_torch.core.client import Problem, TorchContext
from repro_torch.core.clients.torch_fft import (TorchFft2Pallas,
                                                TorchFourStepPallas,
                                                TorchStockhamPallas)
from repro_torch.core.suite import Session, SuiteSpec
from repro_torch.core.tree import BenchNode
from repro_torch.fft.reference import half_roots
from repro_torch.kernels.fft2_pallas import ops as f2
from repro_torch.kernels.stockham_pallas import block, ops, ref
from repro_torch.kernels.stockham_pallas.stockham_pallas import smooth7

TOL = {"float": 1e-5, "double": 1e-12}
REAL = {"float": (np.float32, torch.float32),
        "double": (np.float64, torch.float64)}
CPLX = {"float": torch.complex64, "double": torch.complex128}
ITEM = {"float": 8, "double": 16}
SWEEP = [n for n in range(2, 513) if smooth7(n)]
CSRC = Path(ops.__file__).resolve().parents[2] / "csrc"


def real_rows(shape, precision, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(REAL[precision][0])


def ref_engine(precision):
    tile = None if precision == "float" else 1
    return lambda x, inverse=False: ref_sp.fft(x, inverse=inverse,
                                                tile_b=tile, interpret=True)


def ref_engine2(precision):
    tile = None if precision == "float" else 1
    return lambda x, inverse=False: ref_f2.fft2(x, inverse=inverse,
                                                tile_b=tile, interpret=True)


# --- the wrappers against the reference ------------------------------------
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("n", [2, 3, 12, 45])
def test_rfft_irfft_match_reference(n, precision):
    """A ragged batch of 5 rows: even n packed, odd n whole, n = 2 packed
    to one point; the inverse takes the reference's bins."""
    x = real_rows((5, n), precision, seed=n)
    want = np.asarray(ref_rfft.rfft(x, ref_engine(precision)))
    got = ops.rfft(torch.from_numpy(x))
    assert got.dtype == CPLX[precision] and got.shape == (5, n // 2 + 1)
    assert rel_l2(got, want) <= TOL[precision]
    back = np.asarray(ref_rfft.irfft(want, n, ref_engine(precision)))
    got = ops.irfft(torch.from_numpy(want.copy()), n)
    assert got.dtype == REAL[precision][1] and got.shape == (5, n)
    assert rel_l2(got, back) <= TOL[precision]


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("shape", [(4, 2), (2, 8), (8, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_rfft2_irfft2_match_reference(shape, precision):
    """3 signals, the packed tile from 4 x 1 to 8 x 8."""
    x = real_rows((3, *shape), precision, seed=sum(shape))
    want = np.asarray(ref_rfft.rfftn_packed(x, ref_engine2(precision), 2))
    got = f2.rfft2(torch.from_numpy(x))
    assert got.dtype == CPLX[precision]
    assert got.shape == (3, shape[0], shape[1] // 2 + 1)
    assert rel_l2(got, want) <= TOL[precision]
    back = np.asarray(ref_rfft.irfftn_packed(want, shape,
                                             ref_engine2(precision)))
    got = f2.irfft2(torch.from_numpy(want.copy()), shape[1])
    assert got.shape == (3, *shape)
    assert rel_l2(got, back) <= TOL[precision]


def test_fold_domains_and_plans():
    """The folds take one block's packed axis or tile and a matching plan;
    a length-1 rfft is the identity, launching nothing."""
    with pytest.raises(ValueError, match="within one block"):
        ops.rfft(torch.zeros((1, 32768)))   # packed 16384: two passes
    with pytest.raises(ValueError, match="7-smooth"):
        ops.rfft(torch.zeros((1, 22)))
    with pytest.raises(ValueError, match="even last one"):
        f2.rfft2(torch.zeros((1, 4, 3)))
    with pytest.raises(ValueError, match="within one block"):
        f2.rfft2(torch.zeros((1, 128, 256)))
    with pytest.raises(ValueError, match="do not match"):
        ops.rfft(torch.zeros((1, 12)), twiddles=ops.make_twiddles(
            6, 8, True, torch.complex64, "cpu"))
    with pytest.raises(ValueError, match="bins"):
        ops.irfft(torch.zeros((1, 5), dtype=torch.complex64), 12)
    with pytest.raises(TypeError):
        ops.rfft(torch.zeros((1, 12), dtype=torch.complex64))
    one = torch.ones((3, 1), dtype=torch.float64)
    launches = ops.LAUNCHES
    assert torch.equal(ops.rfft(one), one.to(torch.complex128))
    assert torch.equal(ops.irfft(one.to(torch.complex128), 1), one)
    assert ops.LAUNCHES == launches


# --- the kernel's plain models ----------------------------------------------
def _rand_c(shape, precision, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(z).to(CPLX[precision])


@pytest.mark.parametrize("precision", ["float", "double"])
def test_pass_models_every_length(precision):
    """Every 7-smooth n up to 512, both directions, 3 rows in tiles of 2:
    the pass grouping (``apply_passes``) equals the stage chain
    (``apply_stages``) and the kernel's index model (``run_block``) equals
    both and numpy."""
    dtype = CPLX[precision]
    for n in SWEEP:
        x = _rand_c((3, n), precision, seed=n)
        for inverse in (False, True):
            tw = ops.make_twiddles(n, 8, inverse, dtype, "cpu")
            stages = ref.apply_stages(x, tw.tw, tw.radices, tw.bases, inverse)
            lay = ops.layout(tw, 2, ITEM[precision], block.C2C, inverse)
            groups = tuple(1 if p.rb == 1 else 2 for p in lay.passes)
            passes = ref.apply_passes(x, tw.tw, tw.radices, tw.bases, groups,
                                      inverse)
            model = ref.run_block(x, lay, tw.tw, inverse)
            numpy = (np.fft.ifft(x.numpy()) * n if inverse
                     else np.fft.fft(x.numpy()))
            assert rel_l2(passes, stages) <= TOL[precision], (n, inverse)
            assert rel_l2(model, stages) <= TOL[precision], (n, inverse)
            assert rel_l2(model, numpy) <= TOL[precision], (n, inverse)


def _fold_model(x, n, precision, tile, inverse):
    """``run_block`` as the fold kernel runs: rfft of real rows ``x`` or
    irfft of bins ``x``."""
    dtype = CPLX[precision]
    rows = x.shape[0]
    m = n // 2 if n % 2 == 0 else n
    tw = ops.make_twiddles(m, 8, inverse, dtype, "cpu")
    lay = ops.fold_layout(n, tw, tile, ITEM[precision], inverse)
    roots = half_roots(n, inverse, dtype, device="cpu") if n % 2 == 0 \
        else None
    bins = n // 2 + 1
    if not inverse:
        src = torch.view_as_complex(x.reshape(rows, m, 2)) if n % 2 == 0 \
            else x
        return ref.run_block(src, lay, tw.tw, False, roots,
                             out_shape=(rows, bins), out_dtype=dtype,
                             nyq=n // 2, out_sig=bins, out_row=bins)
    if n % 2:
        return ref.run_block(x, lay, tw.tw, True, roots, out_shape=(rows, n),
                             out_dtype=REAL[precision][1], scale=1.0 / n,
                             nyq=n // 2, in_sig=bins, in_row=bins)
    y = ref.run_block(x, lay, tw.tw, True, roots, out_shape=(rows, m),
                      out_dtype=dtype, scale=1.0 / m, nyq=n // 2,
                      in_sig=bins, in_row=bins)
    return torch.view_as_real(y).reshape(rows, n)


@pytest.mark.parametrize("precision", ["float", "double"])
def test_fold_models_every_length(precision):
    """The fold's index model at every n up to 512 whose packed length is
    7-smooth (even n: the post-pass and pre-pass in the paired butterflies;
    odd n: real loads, bins 0..n/2, the Hermitian half rebuilt on load),
    against numpy's rfft and irfft and against ``rfft.py`` around
    ``apply_stages``."""
    from repro_torch.fft import rfft as rfft_mod
    dtype = CPLX[precision]
    for n in [n for n in range(2, 513)
              if smooth7(n // 2 if n % 2 == 0 else n)]:
        x = torch.from_numpy(real_rows((3, n), precision, seed=n))
        want = torch.from_numpy(np.fft.rfft(x.double().numpy()))
        m = n // 2 if n % 2 == 0 else n
        tw = ops.make_twiddles(m, 8, False, dtype, "cpu")
        stages = rfft_mod.rfft(x, lambda z: ref.apply_stages(
            z, tw.tw, tw.radices, tw.bases, False))
        got = _fold_model(x, n, precision, 2, False)
        assert rel_l2(got, want) <= TOL[precision], n
        assert rel_l2(got, stages) <= TOL[precision], n
        back = _fold_model(want.to(dtype), n, precision, 2, True)
        assert rel_l2(back, x) <= TOL[precision], n


# The engine shapes of P1 (256^3 real: the packed inner axis 128), P4
# (3072^2 real: packed 1536), P5 (945 real) and P6 (128^2 real through
# fft2: the packed 128 x 64 tile), scaled down with their factors kept.
ENGINE_SHAPES = [("P1", (8, 8, 32)), ("P4", (12, 48)), ("P5", (3, 105)),
                 ("P6", (4, 16, 16))]


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("name,shape", ENGINE_SHAPES,
                         ids=[s[0] for s in ENGINE_SHAPES])
def test_fold_models_at_engine_shapes(name, shape, precision):
    """The kernel's model of each problem's fold, every row a signal (P6:
    the fused rank-2 fold on the packed tile), against numpy, in tiles of
    3 (a ragged last tile)."""
    x = torch.from_numpy(real_rows(shape, precision, seed=len(name)))
    dtype = CPLX[precision]
    if name == "P6":
        b, n1, n2 = shape
        h = n2 // 2
        want = torch.from_numpy(np.fft.rfft2(x.double().numpy()))
        for inverse in (False, True):
            tw, roots = f2._fold_plan(n1, n2, 8, inverse, dtype, "cpu", None,
                                      None)
            lay = f2.layout(tw, 3, ITEM[precision], block.EVEN, inverse)
            if not inverse:
                got = ref.run_block(torch.view_as_complex(
                    x.reshape(b, n1, h, 2)), lay, tw.tw, False, roots,
                    out_shape=(b, n1, h + 1), out_dtype=dtype, nyq=h,
                    out_sig=n1 * (h + 1), out_row=h + 1)
                assert rel_l2(got, want) <= TOL[precision]
            else:
                got = ref.run_block(want.to(dtype), lay, tw.tw, True, roots,
                                    out_shape=(b, n1, h), out_dtype=dtype,
                                    scale=1.0 / (n1 * h), nyq=h,
                                    in_sig=n1 * (h + 1), in_row=h + 1)
                got = torch.view_as_real(got).reshape(shape)
                assert rel_l2(got, x) <= TOL[precision]
        return
    n = shape[-1]
    rows = x.reshape(-1, n)
    want = torch.from_numpy(np.fft.rfft(rows.double().numpy()))
    assert rel_l2(_fold_model(rows, n, precision, 3, False), want) \
        <= TOL[precision]
    assert rel_l2(_fold_model(want.to(dtype), n, precision, 3, True), rows) \
        <= TOL[precision]


# --- the host plan ------------------------------------------------------------
def test_pass_cases_match_the_kernel():
    header = (CSRC / "stockham_stages.cuh").read_text()
    cases = re.findall(r"REPRO_PASS\((\d+), (\d+), (\d+)\)", header)
    assert [int(i) for i, _, _ in cases] == list(range(len(cases)))
    assert tuple((int(a), int(b)) for _, a, b in cases) == block.PASS_CASES
    assert f"kMaxPasses = {block.MAX_PASSES};" in header


def test_fast_div():
    rng = np.random.default_rng(0)
    divisors = list(range(1, 600)) + list(rng.integers(1, 1 << 30, 200))
    for d in divisors:
        f = block.fast_div(int(d))
        d = int(d)
        near = np.array([k * d + e for k in (0, 1, 2, 3) for e in (-1, 0, 1)
                         if 0 <= k * d + e < 1 << 31])
        n = np.concatenate([np.arange(0, min(3 * d + 3, 2048)), near,
                            rng.integers(0, (1 << 31) - 1, 64),
                            [(1 << 31) - 1]]).astype(np.int64)
        assert np.array_equal(block.fdiv(f, n), n // d), d
    with pytest.raises(ValueError):
        block.fast_div(0)


def test_p3_layout_is_two_passes_in_one_padded_buffer():
    """P3's 4096 = 8^4 in complex64: two 64-point passes, one barrier, one
    buffer padded so that the first pass's stores (64 points apart) fall
    on distinct banks, 64 threads a row."""
    tw = ops.make_twiddles(4096, 8, False, torch.complex64, "cpu")
    lay = ops.layout(tw, 1, 8)
    assert [(p.ra, p.rb) for p in lay.passes] == [(8, 8), (8, 8)]
    assert lay.family == block.BIG and lay.threads == 64 and lay.buffers == 1
    assert lay.shifts == (6,) and lay.smem == (4096 + 4095 // 64) * 8
    writer, reader = lay.passes
    unpadded = block._bank_cost(writer, reader, 1, 1, block.NO_PAD, 8)
    padded = block._bank_cost(writer, reader, 1, 1, 6, 8)
    assert padded < unpadded
    stores = block._addresses(writer, 1, 32, True)
    assert block.wavefronts(stores + (stores >> 6), 8) == 2 * 64


@pytest.mark.parametrize("precision", ["float", "double"])
def test_layouts_fit_their_kernel(precision):
    """At every 7-smooth n up to the one-block cap (a sweep) and tiles up
    to the default: every pass a case of the layout's family (a fold's
    paired pass among the family's paired cases), no more threads than
    the kernels take, an in-place pass no more butterflies than threads,
    shared memory within the two-buffer bound ``smem_bytes``."""
    dtype, item = CPLX[precision], ITEM[precision]
    cap = ops.ONE_BLOCK_N[dtype]
    for n in [m for m in range(2, cap + 1, 37) if smooth7(m)] + [cap]:
        tw = ops.make_twiddles(n, 8, False, dtype, "cpu")
        tile = ops.default_tile_b(n, 1 << 20, item, len(tw.radices))
        for t in sorted({1, tile}):
            for mode, inverse in ((block.C2C, False), (block.EVEN, False),
                                  (block.EVEN, True), (block.ODD, True)):
                lay = ops.layout(tw, t, item, mode, inverse)
                assert lay.threads <= block.max_threads(lay.family, item)
                for i, p in enumerate(lay.passes):
                    assert block.PASS_CASES.index((p.ra, p.rb)) in \
                        block.family_cases(lay.family, item, p.paired)
                    if 0 < i < len(lay.passes) - 1 and lay.buffers == 1:
                        assert t * p.units(1) <= lay.threads
                assert lay.smem <= ops.smem_bytes(n, t, item,
                                                  len(tw.radices))
                assert lay.smem <= block.SMEM_LIMIT_BYTES


def test_families_match_the_kernel():
    """The host's case families are the kernel's ``family_cases``: the
    header's masks, evaluated here from its source."""
    header = (CSRC / "stockham_stages.cuh").read_text()
    sets = dict(re.findall(
        r"constexpr unsigned long long (k\w+) = bits\(([\d, ]+)\);", header))
    parsed = {k: frozenset(int(c) for c in v.split(",")) for k, v in sets.items()}
    assert parsed["kSingles"] == block._SINGLES
    assert parsed["kOddSingles"] == block._ODD_SINGLES
    assert parsed["kPow2Pairs16"] == block._POW2_PAIRS16
    assert parsed["kOddPairs16"] == block._ODD_PAIRS16
    for itemsize in (8, 16):
        for family in block.FAMILIES:
            for paired in (False, True):
                for c in block.family_cases(family, itemsize, paired):
                    ra, rb = block.PASS_CASES[c]
                    assert ra * rb * (2 if paired else 1) <= 64
    assert ("enum : int { kSmallPow2 = 0, kOddRadix = 1, kBig = 2, "
            "kOneStage = 3 };") in header


# --- the clients' real kinds ---------------------------------------------------
def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)


def test_clients_call_the_new_entries(monkeypatch):
    """On a real kind ``TorchStockhamPallas`` runs its last axis through
    ``ops.rfft`` / ``ops.irfft`` (even and odd n, ranks 1 to 3) and
    ``TorchFft2Pallas`` through ``rfft2`` / ``irfft2``; over one block's
    packed axis (``ONE_BLOCK_N``) the Stockham client keeps ``rfft.py``
    around its engine, and ``TorchFourStepPallas`` never calls a fold."""
    calls: list[str] = []
    for module, names in ((ops, ("rfft", "irfft")), (f2, ("rfft2",
                                                          "irfft2"))):
        for name in names:
            _spy(monkeypatch, module, name, calls)
    session = Session(TorchContext("cpu"))
    spec = SuiteSpec(warmups=0, repetitions=1, output=None)

    def run(cls, extents, kind="Outplace_Real", precision="float"):
        calls.clear()
        rs = session.run(spec, nodes=[BenchNode(
            cls, Problem(extents, kind, precision, 2))])
        assert not rs.failures(), [r.error for r in rs.failures()]
        return sorted(set(calls))

    for extents in ((16,), (15,), (8, 12), (4, 4, 6)):
        assert run(TorchStockhamPallas, extents) == ["irfft", "rfft"]
    assert run(TorchStockhamPallas, (945,), "Inplace_Real", "double") == \
        ["irfft", "rfft"]
    assert run(TorchFft2Pallas, (8, 16)) == ["irfft2", "rfft2"]
    assert run(TorchFourStepPallas, (16,)) == []
    assert run(TorchFourStepPallas, (8, 12)) == []
    assert 16384 > ops.ONE_BLOCK_N[torch.complex64]   # two column passes
    assert run(TorchStockhamPallas, (32768,)) == []
