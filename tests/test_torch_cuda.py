"""Tests of the port that need the card (marker ``cuda``).

They skip on a host without a CUDA GPU.  This file imports neither JAX nor
the reference package, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the kernel against its plain PyTorch version, rel-L2 <= 1e-5
in float and <= 1e-12 in double (the same algorithm and twiddles, only the
summation order differs); against ``torch.fft`` the suite's bar, 1e-3 and
1e-8.  The real-input folds (``ops.rfft`` / ``irfft``, ``rfft2`` /
``irfft2``) hold the same bars against their plain versions
(``fft/rfft.py``'s packing around the plain stages) and
``torch.fft.rfft`` / ``irfft`` / ``rfftn`` / ``irfftn``.  The six-step
and chirp-Z paths (``fft/sixstep.py``, ``fft/bluestein.py``, compositions
of the Stockham and four-step kernels) hold the suite's bar against
``torch.fft``.  The fftconv kernel (float32 only) is held at 1e-5 against its plain
version and against the float64 ``torch.fft`` oracle: a float32 model of
its arithmetic agrees with float64 convolution to ~3e-7 at n = 16384.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.client import KINDS, Problem, TorchContext
from repro_torch.core.clients.torch_fft import (TorchBluestein,
                                                TorchChirpZPallas,
                                                TorchFft2Pallas, TorchPlanned,
                                                TorchSixStep,
                                                TorchStockhamPallas)
from repro_torch.core.suite import Session, SuiteSpec
from repro_torch.core.tree import BenchNode
from repro_torch.fft import bluestein, sixstep
from repro_torch.fft import rfft as rfft_mod
from repro_torch.fft.reference import half_roots
from repro_torch.kernels.dft_matmul import ops as dft_ops
from repro_torch.kernels.dft_matmul import ref as dft_ref
from repro_torch.kernels.fft2_pallas import ops as f2_ops
from repro_torch.kernels.fft2_pallas import ref as f2_ref
from repro_torch.kernels.fft4step import ops as fs_ops
from repro_torch.kernels.fft4step import ref as fs_ref
from repro_torch.kernels.fftconv import ops as conv_ops
from repro_torch.kernels.fftconv import ref as conv_ref
from repro_torch.kernels.stockham_pallas import ops, ref

PLAIN_TOL = {torch.complex64: 1e-5, torch.complex128: 1e-12}
LIBRARY_TOL = {torch.complex64: 1e-3, torch.complex128: 1e-8}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def rel_l2(got, want) -> float:
    return float((got - want).abs().norm() / want.abs().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_kernel_against_plain_and_library(cuda_device, dtype):
    """Every length class up to the one-block cap, radix and direction,
    with a ragged last tile (37 rows in tiles of 8), counting one launch
    per call."""
    rng = np.random.default_rng(11)
    for n in (2, 3, 12, 100, 945, 1024, 3072, ops.ONE_BLOCK_N[dtype]):
        x = torch.from_numpy(rng.standard_normal((37, n)) +
                             1j * rng.standard_normal((37, n))).to(cuda_device, dtype)
        tile = 8 if ops.smem_bytes(n, 8, x.element_size(), 2) \
            <= ops.SMEM_LIMIT_BYTES else 1
        for radix in (2, 4, 8):
            for inverse in (False, True):
                before = ops.LAUNCHES
                y = ops.fft(x, inverse, radix=radix, tile_b=tile)
                torch.cuda.synchronize(cuda_device)
                assert ops.LAUNCHES == before + 1
                plain = ref.stockham_ref(x, radix, inverse)
                lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
                assert rel_l2(y, plain) <= PLAIN_TOL[dtype], (n, radix, inverse)
                assert rel_l2(y, lib) <= LIBRARY_TOL[dtype], (n, radix, inverse)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros((8, 16), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fft(x.transpose(0, 1))
    with pytest.raises(ValueError, match="caps at"):
        ops.fft(torch.zeros((1, 1 << 21), dtype=torch.complex64,
                            device=cuda_device))
    with pytest.raises(ValueError, match="tile_b"):   # 8 rows: 256 KB
        ops.fft(torch.zeros((8, 4096), dtype=torch.complex64,
                            device=cuda_device), tile_b=8)
    with pytest.raises(ValueError, match="tile_b"):   # two passes: no tile
        ops.fft(torch.zeros((4, 16384), dtype=torch.complex64,
                            device=cuda_device), tile_b=1)


@pytest.mark.cuda
def test_session_on_card_launches_the_kernel(cuda_device):
    spec = SuiteSpec(clients=("TorchFFT", "TorchStockhamPallas"),
                     extents=((64,), (8, 12), (4, 4, 8), (945,)), kinds=KINDS,
                     precisions=("float", "double"), warmups=1,
                     repetitions=2, output=None)
    before = ops.LAUNCHES
    rs = Session(TorchContext()).run(spec)
    assert not rs.failures(), [r.error for r in rs.failures()]
    assert {r.device for r in rs.rows} == {torch.cuda.get_device_name(0)}
    assert ops.LAUNCHES > before


def _rand(rows, shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    size = (rows, *shape)
    return torch.from_numpy(rng.standard_normal(size) +
                            1j * rng.standard_normal(size)).to(device, dtype)


def _tiles(fits) -> tuple[int, ...]:
    """Tile 1, and 8 (37 rows: a ragged last tile of 5) where it fits."""
    return (1, 8) if fits(8) else (1,)


FFT2_SHAPES = {
    torch.complex64: ((2, 2), (1, 8), (8, 1), (4, 16), (16, 4), (32, 32),
                      (8, 256), (64, 128), (128, 64), (2, 4096)),
    torch.complex128: ((2, 2), (1, 8), (8, 1), (4, 16), (16, 4), (32, 32),
                       (8, 256), (64, 64), (32, 128), (4096, 1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_fft2_kernel_against_plain_and_library(cuda_device, dtype):
    """2x2 up to the cap, every radix and direction, tile 1 and a ragged
    last tile, one launch per call."""
    for n1, n2 in FFT2_SHAPES[dtype]:
        x = _rand(37, (n1, n2), dtype, cuda_device, n1 * 7 + n2)
        fits = lambda t: f2_ops.smem_bytes(n1 * n2, t, x.element_size(), 2) \
            <= f2_ops.SMEM_LIMIT_BYTES
        for radix in (2, 4, 8):
            for tile in _tiles(fits):
                for inverse in (False, True):
                    before = f2_ops.LAUNCHES
                    y = f2_ops.fft2(x, inverse, radix=radix, tile_b=tile)
                    torch.cuda.synchronize(cuda_device)
                    assert f2_ops.LAUNCHES == before + 1
                    plain = f2_ref.fft2_ref(x, radix, inverse)
                    lib = (torch.fft.ifft2 if inverse else torch.fft.fft2)(x)
                    case = (n1, n2, radix, tile, inverse)
                    assert rel_l2(y, plain) <= PLAIN_TOL[dtype], case
                    assert rel_l2(y, lib) <= LIBRARY_TOL[dtype], case


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_fourstep_kernel_against_plain_and_library(cuda_device, dtype):
    """Square, ragged-split and radix357 lengths up to the cap (16384 in
    both dtypes: two launches in complex128), tile 1 and a ragged last
    tile where one block holds the signal, both directions, one launch per
    call (two for the two-launch form)."""
    for n in (2, 4, 60, 100, 945, 1024, 3072, 4096, 8192,
              fs_ops.MAX_N[dtype]):
        x = _rand(37, (n,), dtype, cuda_device, n)
        n1, n2 = fs_ops.choose_factors(n)
        fits = lambda t: fs_ops.smem_bytes(n1, n2, t, x.element_size()) \
            <= fs_ops.SMEM_LIMIT_BYTES
        one = fs_ops.one_block(n1, n2, x.element_size())
        for tile in (_tiles(fits) if one else (None,)):
            for inverse in (False, True):
                before = fs_ops.LAUNCHES
                y = fs_ops.fft(x, inverse, tile_b=tile)
                torch.cuda.synchronize(cuda_device)
                assert fs_ops.LAUNCHES == before + (1 if one else 2)
                plain = fs_ref.fft4step_ref(x, inverse)
                lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
                assert rel_l2(y, plain) <= PLAIN_TOL[dtype], (n, tile, inverse)
                assert rel_l2(y, lib) <= LIBRARY_TOL[dtype], (n, tile, inverse)


@pytest.mark.cuda
def test_new_wrappers_reject_what_their_kernels_do_not_take(cuda_device):
    x = torch.zeros((4, 16, 16), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        f2_ops.fft2(x.transpose(0, 1))
    with pytest.raises(ValueError, match="caps at n1\\*n2=262144"):
        f2_ops.fft2(torch.zeros((1, 1024, 512), dtype=torch.complex64,
                                device=cuda_device))
    with pytest.raises(ValueError, match="tile_b"):
        f2_ops.fft2(torch.zeros((4, 64, 128), dtype=torch.complex64,
                                device=cuda_device), tile_b=4)
    with pytest.raises(ValueError, match="contiguous"):
        fs_ops.fft(x[:, 0, :].transpose(0, 1))
    with pytest.raises(ValueError, match="factorization"):
        fs_ops.fft(torch.zeros((1, 32768), dtype=torch.complex128,
                               device=cuda_device))
    with pytest.raises(ValueError, match="tile_b"):
        fs_ops.fft(torch.zeros((8, 4096), dtype=torch.complex64,
                               device=cuda_device), tile_b=8)


@pytest.mark.cuda
def test_session_on_card_launches_the_new_kernels(cuda_device):
    spec = SuiteSpec(clients=("TorchFourStepPallas", "TorchFft2Pallas"),
                     extents=((8, 16), (64, 32)), kinds=KINDS,
                     precisions=("float", "double"), warmups=1,
                     repetitions=2, output=None)
    f2_before, fs_before = f2_ops.LAUNCHES, fs_ops.LAUNCHES
    rs = Session(TorchContext()).run(spec)
    assert not rs.failures(), [r.error for r in rs.failures()]
    assert f2_ops.LAUNCHES > f2_before and fs_ops.LAUNCHES > fs_before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_dft_kernel_against_plain_and_library(cuda_device, dtype):
    """Every length up to the cap of 128 (the FFT body on the 7-smooth
    ones, the direct product on the rest), tile 1, a ragged last tile (37
    rows in tiles of 8) and the default, both directions, one launch per
    call; against the body's plain version and the direct product."""
    for n in range(1, 129):
        x = _rand(37, (n,), dtype, cuda_device, n)
        for inverse in (False, True):
            m = dft_ops.make_matrix(n, inverse, dtype, cuda_device)
            yr, yi = dft_ref.dft_ref(x.real.contiguous(),
                                     x.imag.contiguous(), inverse)
            direct = torch.complex(yr, yi) / (n if inverse else 1)
            plain = dft_ops.plain(x, m, inverse)
            lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
            for tile in (1, 8, None):
                before = dft_ops.LAUNCHES
                y = dft_ops.dft(x, inverse, tile_b=tile, matrix=m)
                torch.cuda.synchronize(cuda_device)
                assert dft_ops.LAUNCHES == before + 1
                case = (n, tile, inverse)
                assert rel_l2(y, plain) <= PLAIN_TOL[dtype], case
                assert rel_l2(y, direct) <= PLAIN_TOL[dtype], case
                assert rel_l2(y, lib) <= LIBRARY_TOL[dtype], case


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_stockham_two_passes_on_card(cuda_device, dtype):
    """Lengths over the one-block cap up to 2^20 (a power of two and
    945 x 81 = 76545), both directions, two launches per call, against
    the two-pass plain version and torch.fft."""
    for n in (16384 if dtype == torch.complex64 else 8192, 76545, 1 << 20):
        x = _rand(2, (n,), dtype, cuda_device, n)
        for inverse in (False, True):
            plan = ops.make_twiddles(n, 8, inverse, dtype, cuda_device)
            assert isinstance(plan, ops.TwoPass)
            before = ops.LAUNCHES
            y = ops.fft(x, inverse, twiddles=plan)
            torch.cuda.synchronize(cuda_device)
            assert ops.LAUNCHES == before + 2
            plain = ops.plain(x, plan, inverse) / (n if inverse else 1)
            lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
            assert rel_l2(y, plain) <= PLAIN_TOL[dtype], (n, inverse)
            assert rel_l2(y, lib) <= LIBRARY_TOL[dtype], (n, inverse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_fft2_passes_on_card(cuda_device, dtype):
    """Tiles over the one-block cap up to 2^18 points: square ones, long
    rows and long columns (two passes on that axis), both directions."""
    for n1, n2, launches in ((128, 128, 2), (256, 256, 2), (512, 512, 2),
                             (16, 16384, 3), (32768, 8, 3)):
        x = _rand(2, (n1, n2), dtype, cuda_device, n1 + n2)
        for inverse in (False, True):
            plan = f2_ops.make_twiddles2(n1, n2, 8, inverse, dtype,
                                         cuda_device)
            before = f2_ops.LAUNCHES
            y = f2_ops.fft2(x, inverse, twiddles=plan)
            torch.cuda.synchronize(cuda_device)
            assert f2_ops.LAUNCHES == before + launches
            plain = f2_ops.plain(x, plan, inverse) / (n1 * n2 if inverse
                                                      else 1)
            lib = (torch.fft.ifft2 if inverse else torch.fft.fft2)(x)
            case = (n1, n2, inverse)
            assert rel_l2(y, plain) <= PLAIN_TOL[dtype], case
            assert rel_l2(y, lib) <= LIBRARY_TOL[dtype], case


@pytest.mark.cuda
def test_backends_table_nodes_on_card(cuda_device):
    """The reference's backends table's 65536 and 256x256 Outplace_Real
    nodes validate, each launching only its own kernel."""
    session = Session(TorchContext())
    for client, ext, mod in ((TorchStockhamPallas, (65536,), ops),
                             (TorchFft2Pallas, (256, 256), f2_ops)):
        others = [m for m in (ops, f2_ops, fs_ops, dft_ops) if m is not mod]
        before = [m.LAUNCHES for m in (mod, *others)]
        rs = session.run(SuiteSpec(output=None), nodes=[BenchNode(
            client, Problem(ext, "Outplace_Real"))])
        assert not rs.failures(), [r.error for r in rs.failures()]
        after = [m.LAUNCHES for m in (mod, *others)]
        assert after[0] > before[0] and after[1:] == before[1:]


@pytest.mark.cuda
def test_dft_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros((8, 16), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        dft_ops.dft(x.transpose(0, 1))
    with pytest.raises(ValueError, match="caps at n=128"):
        dft_ops.dft(torch.zeros((1, 129), dtype=torch.complex64,
                                device=cuda_device))
    with pytest.raises(ValueError, match="tile_b"):
        dft_ops.dft(torch.zeros((256, 128), dtype=torch.complex128,
                                device=cuda_device), tile_b=200)


@pytest.mark.cuda
def test_planner_on_card_runs_the_dft_kernel(cuda_device, tmp_path):
    """ESTIMATE pins a short rank-1 problem to the dft kernel; MEASURE
    times every candidate on the card and writes wisdom; WISDOM_ONLY runs
    the recorded pick."""
    problem = Problem((100,), "Inplace_Real", "double", 64)
    nodes = [BenchNode(TorchPlanned, problem)]
    session = Session(TorchContext())
    before = dft_ops.LAUNCHES
    rs = session.run(SuiteSpec(output=None), nodes=nodes)
    assert not rs.failures(), [r.error for r in rs.failures()]
    assert dft_ops.LAUNCHES > before
    wisdom = str(tmp_path / "wisdom.json")
    for rigor in ("measure", "wisdom_only"):
        rs = session.run(SuiteSpec(rigor=rigor, wisdom=wisdom, output=None),
                         nodes=nodes)
        assert not rs.failures(), [r.error for r in rs.failures()]
        sources = {r.plan_source for r in rs.rows
                   if r.library == "TorchPlanned" and r.op != "validate"}
        assert sources == {"measure" if rigor == "measure" else "wisdom"}


def _conv_case(c, b, L, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, b, L)).astype(np.float32)
    h = (rng.standard_normal((c, K)) / np.sqrt(K)).astype(np.float32)
    return x, h


def _check_conv(device, x, h, tile_b):
    """One kernel launch on the card against the plain version on the
    same operands (1e-5) and the float64 oracle (1e-5)."""
    xd, hd = torch.from_numpy(x).to(device), torch.from_numpy(h).to(device)
    op = conv_ops.prepare(xd, hd, tile_b=tile_b)
    before = conv_ops.LAUNCHES
    y = conv_ops.fftconv(xd, hd, tile_b=tile_b)
    torch.cuda.synchronize(device)
    assert conv_ops.LAUNCHES == before + 1
    assert y.shape == xd.shape and y.dtype == torch.float32
    plain = op.plain()
    oracle = conv_ref.fftconv_ref(xd.double(), hd.double(), op.n)
    case = (x.shape, h.shape, op.n, op.tile_b)
    assert rel_l2(y, plain) <= 1e-5, case
    assert rel_l2(y.double(), oracle) <= 1e-5, case


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32, 64, 128])
def test_fftconv_kernel_against_plain_and_oracle(cuda_device, k):
    """Every length n = k*k: one and three channels, one and five signals
    (five in tiles of 2 or more: a ragged last tile), one tap and L taps,
    every tile that fits a block, up to the largest."""
    n = k * k
    tiles = range(1, conv_ops.largest_tile_b(n) + 1)
    for c, b in ((1, 1), (3, 5)):
        for L, K in ((n, 1), ((n + 1) // 2, (n + 1) // 2)):
            x, h = _conv_case(c, b, L, K, seed=k * 31 + c * b + K)
            assert conv_ops._next_square_pow2(L + K - 1) == n
            for tile in tiles:
                _check_conv(cuda_device, x, h, tile)


@pytest.mark.cuda
def test_fftconv_kernel_at_the_cap(cuda_device):
    """n = 16384 with the largest tile that fits (one signal per block); a
    tile that does not fit raises before any launch."""
    assert conv_ops.largest_tile_b(16384) == 1
    x, h = _conv_case(2, 3, 16384 - 127, 128, seed=5)
    _check_conv(cuda_device, x, h, None)
    before = conv_ops.LAUNCHES
    with pytest.raises(ValueError, match="does not fit"):
        conv_ops.fftconv(torch.from_numpy(x).to(cuda_device),
                         torch.from_numpy(h).to(cuda_device), tile_b=2)
    assert conv_ops.LAUNCHES == before


@pytest.mark.cuda
def test_kernel_table_on_card(cuda_device):
    """The kernel table's specs through Session.run on the card: every
    node validated, the fftconv kernel launched."""
    from repro_torch.benchmarks import table_kernels as tk
    from dataclasses import replace
    before = conv_ops.LAUNCHES
    session = Session(TorchContext())
    for spec in tk.SPECS:
        rs = session.run(replace(spec, warmups=0, repetitions=1))
        assert not rs.failures(), [r.error for r in rs.failures()]
        assert len(rs.query(op="validate")) == len(spec.clients)
    assert conv_ops.LAUNCHES > before


def _fold_rows(rows, shape, real, device, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((rows, *shape))).to(device,
                                                                    real)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_stockham_folds_against_plain_and_library(cuda_device, dtype):
    """rfft / irfft along the last axis: even and odd n, n = 2 (one packed
    point), P1's, P4's and P5's axes, the largest even and odd lengths one
    block folds; 37 rows in tiles of 1, 8 (a ragged last tile) and the
    default; one launch a call."""
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    item = 16 if dtype == torch.complex128 else 8
    cap = ops.ONE_BLOCK_N[dtype]
    odd_cap = max(m for m in range(1, cap + 1, 2) if ops.smooth7(m))
    for n in (2, 3, 4, 5, 12, 15, 256, 945, 1536, 2 * cap, odd_cap):
        m = n // 2 if n % 2 == 0 else n
        x = _fold_rows(37, (n,), real, cuda_device, n)
        fwd = ops.make_twiddles(m, 8, False, dtype, cuda_device)
        inv = ops.make_twiddles(m, 8, True, dtype, cuda_device)
        rf = half_roots(n, False, dtype, device=cuda_device) if n % 2 == 0 \
            else None
        ri = half_roots(n, True, dtype, device=cuda_device) if n % 2 == 0 \
            else None
        lib = torch.fft.rfft(x)
        plain = rfft_mod.rfft(x, lambda z: ops.plain(z, fwd, False), rf)
        plain_i = rfft_mod.irfft(lib, n, lambda z, inverse=False:
                                 ops.plain(z, inv, True) / m, ri)
        tiles = (1, 8, None) if ops.smem_bytes(m, 8, item, 2) \
            <= ops.SMEM_LIMIT_BYTES else (1, None)
        for tile in tiles:
            before = ops.LAUNCHES
            y = ops.rfft(x, tile_b=tile, twiddles=fwd, roots=rf)
            back = ops.irfft(lib, n, tile_b=tile, twiddles=inv, roots=ri)
            torch.cuda.synchronize(cuda_device)
            assert ops.LAUNCHES == before + 2
            assert y.shape == (37, n // 2 + 1) and back.shape == (37, n)
            case = (n, tile)
            assert rel_l2(y, plain) <= PLAIN_TOL[dtype], case
            assert rel_l2(y, lib) <= LIBRARY_TOL[dtype], case
            assert rel_l2(back, plain_i) <= PLAIN_TOL[dtype], case
            assert rel_l2(back, x) <= LIBRARY_TOL[dtype], case


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_fft2_folds_against_plain_and_library(cuda_device, dtype):
    """rfft2 / irfft2 over the last two axes: the packed tile from 1 x 1
    (n2 = 2) to one block's cap, long rows and long columns, 37 signals in
    tiles of 1, 8 where it fits and the default; one launch a call."""
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    item = 16 if dtype == torch.complex128 else 8
    shapes = ((1, 2), (2, 2), (4, 16), (16, 4), (8, 256), (4096, 2),
              (2, 8192 if dtype == torch.complex64 else 4096),
              (128, 128) if dtype == torch.complex64 else (64, 128))
    for n1, n2 in shapes:
        h = n2 // 2
        x = _fold_rows(37, (n1, n2), real, cuda_device, n1 + n2)
        fwd = f2_ops.make_twiddles2(n1, h, 8, False, dtype, cuda_device)
        inv = f2_ops.make_twiddles2(n1, h, 8, True, dtype, cuda_device)
        rf = half_roots(n2, False, dtype, device=cuda_device)
        ri = half_roots(n2, True, dtype, device=cuda_device)
        lib = torch.fft.rfft2(x)
        plain = rfft_mod.rfftn_packed(x, lambda z: f2_ops.plain(z, fwd, False),
                                      2, rf)
        plain_i = rfft_mod.irfftn_packed(
            lib, (n1, n2), lambda z, inverse=False:
            f2_ops.plain(z, inv, True) / (n1 * h), ri)
        tiles = (1, 8, None) if f2_ops.smem_bytes(n1 * h, 8, item, 2) \
            <= f2_ops.SMEM_LIMIT_BYTES else (1, None)
        for tile in tiles:
            before = f2_ops.LAUNCHES
            y = f2_ops.rfft2(x, tile_b=tile, twiddles=fwd, roots=rf)
            back = f2_ops.irfft2(lib, n2, tile_b=tile, twiddles=inv,
                                 roots=ri)
            torch.cuda.synchronize(cuda_device)
            assert f2_ops.LAUNCHES == before + 2
            case = (n1, n2, tile)
            assert rel_l2(y, plain) <= PLAIN_TOL[dtype], case
            assert rel_l2(y, lib) <= LIBRARY_TOL[dtype], case
            assert rel_l2(back, plain_i) <= PLAIN_TOL[dtype], case
            assert rel_l2(back, x) <= LIBRARY_TOL[dtype], case


@pytest.mark.cuda
def test_fold_wrappers_raise_on_the_card(cuda_device):
    """A CUDA tensor the fold does not take raises: no other path."""
    with pytest.raises(ValueError, match="within one block"):
        ops.rfft(torch.zeros((1, 32768), device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        ops.rfft(torch.zeros((16, 4), device=cuda_device).T)
    with pytest.raises(ValueError, match="within one block"):
        f2_ops.rfft2(torch.zeros((1, 128, 256), device=cuda_device))
    with pytest.raises(ValueError, match="tile_b"):
        f2_ops.rfft2(torch.zeros((8, 128, 128), device=cuda_device),
                     tile_b=8)


@pytest.mark.cuda
def test_session_real_kinds_launch_the_folds(cuda_device):
    """Real kinds on the Stockham and fft2 clients launch the folds (their
    own keys in ``LAUNCH_SHAPES``) and validate."""
    session = Session(TorchContext())
    for cls, ext, mod, keys in (
            (TorchStockhamPallas, (945,), ops, {"rfft", "irfft"}),
            (TorchStockhamPallas, (64, 96), ops, {"rfft", "irfft"}),
            (TorchFft2Pallas, (64, 64), f2_ops, {"rfft2", "irfft2"})):
        for precision in ("float", "double"):
            mod.LAUNCH_SHAPES.clear()
            rs = session.run(SuiteSpec(output=None), nodes=[BenchNode(
                cls, Problem(ext, "Outplace_Real", precision, 3))])
            assert not rs.failures(), [r.error for r in rs.failures()]
            folds = {k[0] for k in mod.LAUNCH_SHAPES if isinstance(k[0], str)}
            assert folds == keys, (cls.title, ext, precision, folds)


def _launches():
    return ops.LAUNCHES, fs_ops.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n", [1 << 16, 1 << 22])
def test_sixstep_against_library(cuda_device, n, dtype):
    """The six-step composition at 2^16 and 2^22 (splits 4 x 16384 and
    256 x 16384; the four-step side as two launches in complex128),
    forward and inverse, against torch.fft; each call launches the
    Stockham kernel once and the four-step kernel once or twice."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((3, n)) +
                         1j * rng.standard_normal((3, n))).to(cuda_device, dtype)
    for inverse in (False, True):
        plan = sixstep.make_plan(n, inverse, dtype, cuda_device)
        before = _launches()
        y = sixstep.fft(x, inverse, plan=plan)
        torch.cuda.synchronize(cuda_device)
        sp, fs = (a - b for a, b in zip(_launches(), before))
        assert sp == 1 and fs == (2 if dtype == torch.complex128 else 1)
        lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
        assert rel_l2(y, lib) <= LIBRARY_TOL[dtype], (n, inverse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n", [19 ** 3, 19 ** 4])
def test_chirpz_against_library(cuda_device, n, dtype):
    """Chirp-Z at 19^3 ("auto": the Stockham kernel at m = 13720, two
    column passes in complex128) and 19^4 ("auto": six-step at m = 2^18),
    and each forced engine, forward and inverse, against torch.fft; the
    padded transforms launch the kernels of their engine and no other."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((3, n)) +
                         1j * rng.standard_normal((3, n))).to(cuda_device, dtype)
    for engine in ("auto", "stockham_pallas", "sixstep"):
        for inverse in (False, True):
            plan = bluestein.make_plan(n, inverse, dtype, cuda_device, engine)
            assert plan.engine == (bluestein.resolve_engine(n, engine)[0])
            before = _launches()
            y = bluestein.fft(x, inverse, plan=plan)
            torch.cuda.synchronize(cuda_device)
            sp, fs = (a - b for a, b in zip(_launches(), before))
            assert sp > 0 and (fs > 0) == (plan.engine == "sixstep")
            lib = (torch.fft.ifft if inverse else torch.fft.fft)(x)
            assert rel_l2(y, lib) <= LIBRARY_TOL[dtype], (n, engine, inverse)


@pytest.mark.cuda
def test_new_clients_validate_on_the_card(cuda_device):
    """``TorchSixStep``, ``TorchChirpZPallas`` and ``TorchBluestein``
    through ``Session.run`` on every kind: every node validates; the
    bluestein baseline launches no kernel."""
    session = Session(TorchContext())
    for cls, ext in ((TorchSixStep, (1 << 16,)), (TorchSixStep, (64, 128)),
                     (TorchChirpZPallas, (19 ** 3,)),
                     (TorchChirpZPallas, (19, 19)),
                     (TorchBluestein, (19 ** 3,))):
        for kind in KINDS:
            for precision in ("float", "double"):
                before = _launches()
                rs = session.run(SuiteSpec(output=None), nodes=[BenchNode(
                    cls, Problem(ext, kind, precision, 2))])
                assert not rs.failures(), [r.error for r in rs.failures()]
                launched = [a - b for a, b in zip(_launches(), before)]
                assert (sum(launched) == 0) == (cls is TorchBluestein), \
                    (cls.title, ext, kind, precision, launched)


def _serve_payloads(extents, n, dtype, seed):
    rng = np.random.default_rng(seed)
    shape = (n, *extents)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return [r.astype(dtype) for r in x]


@pytest.mark.cuda
def test_serve_pinned_stockham_burst(cuda_device):
    """A coalesced burst on the pinned Stockham kernel: every result
    agrees with torch.fft on the card, and the kernel launched."""
    from repro_torch.serve import FFTService, ServeConfig

    xs = _serve_payloads((4096,), 64, np.complex64, 5)
    cfg = ServeConfig(coalesce_window_ms=2.0, max_batch=16,
                      backend="stockham_pallas")
    with FFTService(Session(TorchContext(cuda_device)), cfg) as svc:
        svc.prewarm((4096,))
        before = ops.LAUNCHES
        reqs = svc.submit_many(xs)
        outs = [r.result(timeout=300) for r in reqs]
        launched = ops.LAUNCHES - before
    rep = svc.report()
    assert rep["completed"] == 64 and rep["errors"] == 0
    assert rep["batches"] < 64 and launched >= rep["batches"]
    assert not rep["worker_errors"] and rep["demotions"] == 0
    for x, y in zip(xs, outs):
        want = torch.fft.fft(torch.from_numpy(x).to(cuda_device))
        assert rel_l2(torch.from_numpy(y[0]).to(cuda_device), want) <= 1e-3


@pytest.mark.cuda
def test_serve_two_worker_replay(cuda_device):
    """Two workers, each on its own stream, three batches in flight each:
    every request of a mixed replay is delivered and agrees with
    torch.fft of its payload on the card."""
    from repro_torch.serve import (FFTService, ServeConfig, TrafficSpec,
                                   replay)
    from repro_torch.serve.replay import _payloads

    spec = TrafficSpec(extents=("1024", "945", "64x64"),
                       kinds=("Outplace_Complex", "Outplace_Real"),
                       requests=64, batch=8, seed=3)
    cfg = ServeConfig(coalesce_window_ms=1.0, max_batch=64, workers=2,
                      inflight=3)
    with FFTService(Session(TorchContext(cuda_device)), cfg) as svc:
        for ext, kind, prec in spec.mix():
            svc.prewarm(ext, kind, prec)
        rep = replay(svc, spec)
    assert rep.service["completed"] == 64 and rep.service["errors"] == 0
    assert not rep.service["worker_errors"]
    payloads = _payloads(spec)
    for req in rep.requests:
        x = torch.from_numpy(payloads[req.plan_key]).to(cuda_device)
        dims = tuple(range(-len(req.extents), 0))
        want = (torch.fft.fftn(x, dim=dims) if x.is_complex()
                else torch.fft.rfftn(x, dim=dims))
        got = torch.from_numpy(req.result(timeout=60)).to(cuda_device)
        assert rel_l2(got, want) <= 1e-3


@pytest.mark.cuda
def test_serve_probe_fails_a_non_finite_request_alone(cuda_device):
    """The finiteness probe on the card (a flag per row, computed on the
    worker's stream): a request whose transform is not finite fails, its
    batchmates are delivered and agree with torch.fft."""
    from repro_torch.serve import FFTService, ServeConfig, ServeError

    xs = _serve_payloads((4096,), 8, np.complex64, 7)
    xs[3][17] = np.inf
    cfg = ServeConfig(coalesce_window_ms=2.0, max_batch=16,
                      backend="stockham_pallas")
    with FFTService(Session(TorchContext(cuda_device)), cfg) as svc:
        svc.prewarm((4096,))
        reqs = svc.submit_many(xs)
        with pytest.raises(ServeError, match="non-finite output"):
            reqs[3].result(timeout=300)
        outs = {i: r.result(timeout=300) for i, r in enumerate(reqs)
                if i != 3}
    rep = svc.report()
    assert rep["completed"] == 7 and rep["errors"] == 1
    for i, y in outs.items():
        want = torch.fft.fft(torch.from_numpy(xs[i]).to(cuda_device))
        assert rel_l2(torch.from_numpy(y[0]).to(cuda_device), want) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("natural", [False, True])
def test_dist_transforms_on_a_one_rank_nccl_group(cuda_device, natural):
    """dist1d and slab on the one-rank ``nccl`` group a CUDA client starts
    (``flat_mesh``): the collective runs at P = 1, the local engines are
    the kernels (``dft`` up to 128 points, the four-step kernel above),
    the spectra agree with torch.fft and the inverses round-trip."""
    import torch.distributed as dist

    from repro_torch.core.candidates import Candidate
    from repro_torch.core.clients.dist_fft import dist_engines
    from repro_torch.fft import distributed as dfft
    from repro_torch.launch.mesh import flat_mesh

    mesh = flat_mesh(device=cuda_device)
    assert dist.get_backend() == "nccl" and mesh.size == 1
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    n = 1 << 16                                  # 256 x 256
    x = torch.randn(n, dtype=torch.complex64, generator=gen,
                    device=cuda_device)
    problem = Problem((n,), "Outplace_Complex")
    fwd_eng, _ = dist_engines(problem, Candidate("dist1d", mesh=(1,)),
                              False, cuda_device)
    inv_eng, _ = dist_engines(problem, Candidate("dist1d", mesh=(1,)),
                              True, cuda_device)
    fn, (n1, n2) = dfft.make_fft1d(mesh, "data", n, natural=natural,
                                   engines=fwd_eng, device=cuda_device)
    inv, _ = dfft.make_ifft1d(mesh, "data", n, natural=natural,
                              engines=inv_eng, device=cuda_device)
    calls, before = dfft.A2A_CALLS, fs_ops.LAUNCHES
    y = fn(x)
    assert dfft.A2A_CALLS - calls == (3 if natural else 2)
    assert fs_ops.LAUNCHES > before
    want = torch.fft.fft(x)
    if not natural:
        want = want.reshape(n2, n1).T.reshape(-1)
    assert rel_l2(y, want) <= LIBRARY_TOL[torch.complex64]
    assert rel_l2(inv(y), x) <= LIBRARY_TOL[torch.complex64]

    shape = (64, 32, 16)
    xs = torch.randn((2, *shape), dtype=torch.complex128, generator=gen,
                     device=cuda_device)
    problem = Problem(shape, "Outplace_Complex", "double", 2)
    cand = Candidate("slab", mesh=(1,))
    fn, ins, outs = dfft.make_slab_fftnd(
        mesh, "data", shape, natural=natural,
        engines=dist_engines(problem, cand, False, cuda_device)[0])
    inv, _, _ = dfft.make_slab_fftnd(
        mesh, "data", shape, natural=natural, inverse=True,
        engines=dist_engines(problem, cand, True, cuda_device)[0])
    before = dft_ops.LAUNCHES
    ys = fn(xs)
    assert dft_ops.LAUNCHES > before
    assert rel_l2(ys, torch.fft.fftn(xs, dim=(1, 2, 3))) \
        <= LIBRARY_TOL[torch.complex128]
    assert rel_l2(inv(ys), xs) <= LIBRARY_TOL[torch.complex128]


def _lm_pair(arch, device, n_layers=2):
    """A reduced float32 model on the CPU and a copy of its weights on the
    card."""
    import copy
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config(arch).reduced(n_layers=n_layers),
                              dtype=torch.float32)
    cpu = Model(cfg, device="cpu")
    params = cpu.init_params(torch.Generator("cpu").manual_seed(0))
    return cpu, params, Model(cfg, device=device), \
        copy.deepcopy(params).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m"])
def test_lm_decoder_on_card_is_the_cpu(cuda_device, arch):
    """forward, prefill and two decode steps on ``cuda:0`` against the same
    float32 model on the CPU (rel-L2 <= 1e-5; TF32 stays off)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cpu, params, card, on_card = _lm_pair(arch, cuda_device)
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, cpu.cfg.vocab_size, (2, 20)).astype(np.int32))
    want, _, _ = cpu.forward(params, tok)
    got, _, _ = card.forward(on_card, tok.to(cuda_device))
    assert got.device == cuda_device and rel_l2(got.cpu(), want) <= 1e-5
    c_cpu, c_card = cpu.init_cache(2, 32), card.init_cache(2, 32)
    assert c_card["k"].device == cuda_device
    want, c_cpu = cpu.prefill(params, tok[:, :18], c_cpu)
    got, c_card = card.prefill(on_card, tok[:, :18].to(cuda_device), c_card)
    assert rel_l2(got.cpu(), want) <= 1e-5
    for t in (18, 19):
        want, c_cpu = cpu.decode_step(params, tok[:, t:t + 1], c_cpu, t)
        got, c_card = card.decode_step(on_card,
                                       tok[:, t:t + 1].to(cuda_device),
                                       c_card, t)
        assert rel_l2(got.cpu(), want) <= 1e-5


@pytest.mark.cuda
def test_lm_serve_engine_on_card(cuda_device):
    """``ServeEngine`` on the card (bf16 weights cast once, the cache on
    the card) completes every request; in float32 its greedy streams are
    the CPU engine's."""
    import dataclasses

    from repro_torch.launch.serve import Request, ServeEngine

    cpu, params, card, on_card = _lm_pair("qwen3-1.7b", cuda_device)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (5, 9, 3, 7, 4)]
    streams = []
    for model, p in ((cpu, params), (card, on_card)):
        engine = ServeEngine(model, p, batch_slots=2, max_len=32)
        assert engine.cache["k"].device == model.device
        reqs = [Request(i, q, 4) for i, q in enumerate(prompts)]
        pending = list(reqs)
        for _ in range(100):
            while pending and engine.submit(pending[0]):
                pending.pop(0)
            if engine.step() == 0 and not pending:
                break
        assert all(r.done and len(r.out) == 4 for r in reqs)
        streams.append([[int(t) for t in r.out] for r in reqs])
    assert streams[0] == streams[1]
    bf16 = dataclasses.replace(card.cfg, dtype=torch.bfloat16)
    engine = ServeEngine(type(card)(bf16, device=cuda_device), on_card,
                         batch_slots=2, max_len=32)
    assert engine.params.layers[0].attn.wq.w.dtype == torch.bfloat16
    req = Request(0, prompts[0], 6)
    assert engine.submit(req)
    while engine.step():
        pass
    assert req.done and len(req.out) == 6


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_lm_recurrent_kinds_serve_on_card(cuda_device, arch):
    """Reduced hymba (its meta tokens, the window binding) and xlstm, four
    layers, float32 on ``cuda:0``: ``ServeEngine`` completes three
    requests through two slots (the refill scatters the recurrent
    states); a decode after a prefill of 20 tokens is the forward's
    column 20 (rel-L2 <= 1e-4) and the CPU's decode (<= 1e-5)."""
    from repro_torch.launch.serve import Request, ServeEngine

    cpu, params, card, on_card = _lm_pair(arch, cuda_device, n_layers=4)
    rng = np.random.default_rng(7)
    engine = ServeEngine(card, on_card, batch_slots=2, max_len=32)
    reqs = [Request(i, rng.integers(0, 256, (n,)).astype(np.int32), 4)
            for i, n in enumerate((5, 9, 3))]
    pending = list(reqs)
    for _ in range(100):
        while pending and engine.submit(pending[0]):
            pending.pop(0)
        if engine.step() == 0 and not pending:
            break
    assert all(r.done and len(r.out) == 4 for r in reqs)
    tok = torch.from_numpy(rng.integers(0, 256, (2, 21)).astype(np.int32))
    full, _, _ = card.forward(on_card, tok.to(cuda_device))
    cache = card.init_cache(2, 32)
    _, cache = card.prefill(on_card, tok[:, :20].to(cuda_device), cache)
    step, _ = card.decode_step(on_card, tok[:, 20:].to(cuda_device), cache,
                               20)
    assert rel_l2(step[:, 0], full[:, 20]) <= 1e-4
    c_cpu = cpu.init_cache(2, 32)
    _, c_cpu = cpu.prefill(params, tok[:, :20], c_cpu)
    want, _ = cpu.decode_step(params, tok[:, 20:], c_cpu, 20)
    assert rel_l2(step.cpu(), want) <= 1e-5


@pytest.mark.cuda
def test_lm_train_step_and_checkpoint_on_card(cuda_device, tmp_path):
    """A reduced qwen3-1.7b training step on the card (float32): its loss
    finite and within 1e-4 of the same step on the CPU; then the
    ``Trainer`` on the card to step 2, a checkpoint, and its resume to
    step 4 equal to an uninterrupted run to step 4 (1e-5 per leaf)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.trainer import (TrainConfig, Trainer,
                                           build_train_step)

    cpu, params, card, on_card = _lm_pair("qwen3-1.7b", cuda_device)
    data = SyntheticTokens(DataConfig(vocab_size=cpu.cfg.vocab_size,
                                      seq_len=32, global_batch=4))
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    losses = []
    for model, p in ((cpu, params), (card, on_card)):
        _, state, m = build_train_step(model, opt)(p, init_opt_state(p),
                                                   data.batch(0))
        assert int(state["step"]) == 1
        losses.append(float(m["loss"]))
    assert np.isfinite(losses[1]) and abs(losses[1] - losses[0]) <= \
        1e-4 * abs(losses[0])

    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(n_layers=2),
                              dtype=torch.float32)

    def run(directory, steps):
        tcfg = TrainConfig(steps=steps, checkpoint_every=2,
                           checkpoint_dir=str(directory), log_every=100,
                           opt=opt)
        return Trainer(Model(cfg, device=cuda_device, remat=False), data,
                       tcfg).run(verbose=False)
    run(tmp_path / "a", 2)
    resumed = run(tmp_path / "a", 4)
    straight = run(tmp_path / "b", 4)
    assert resumed["step"] == straight["step"] == 4
    for (name, a), b in zip(resumed["params"].named_parameters(),
                            straight["params"].parameters()):
        assert a.device == cuda_device
        assert rel_l2(a.detach().cpu(), b.detach().cpu()) <= 1e-5, name
