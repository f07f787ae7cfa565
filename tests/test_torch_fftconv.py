"""The port's fftconv (the fused kernel module and ``fft/fftconv.py``)
against the reference package's.

Inputs come from a seeded numpy generator and go through both packages:
the reference's ``ops.fftconv`` runs its Pallas kernel in interpret mode,
the port's ``ops.fftconv`` on a CPU tensor takes the kernel's plain
version (``ref.fftconv_plain``); both are also held against a float64
direct causal convolution.

Tolerance: rel-L2 <= 1e-5.  The two kernels compute the same
convolution at the same length n in float32 by different algorithms (the
reference's dense k x k four-step products, the port's two real FFTs of
radix-8/4/2 stages), each with tables built in float64 and cast once;
each agrees with float64 convolution to ~3e-7 at n = 16384.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.accuracy import rel_l2

from repro.fft import fftconv as ref_fftconv
from repro.fft import reference as ref_tables
from repro.kernels.fftconv import fftconv as ref_kernel
from repro.kernels.fftconv import ops as ref_ops
from repro.kernels.fftconv import ref as ref_ref
from repro_torch.fft import fftconv as port_fftconv
from repro_torch.kernels import _build
from repro_torch.kernels.fftconv import ops, ref

TOL = 1e-5

#: The reference test's four cases (C, B, L, K), and a ragged batch (5
#: signals in tiles of 4).
CASES = [(2, 4, 100, 5), (1, 1, 512, 64), (3, 2, 1000, 24),
         (2, 8, 8000, 128), (3, 5, 300, 40)]


def conv_case(c, b, L, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, b, L)).astype(np.float32)
    h = (rng.standard_normal((c, K)) / np.sqrt(K)).astype(np.float32)
    return x, h


def direct_conv(x, h):
    """Causal linear convolution in float64, term by term."""
    L = x.shape[-1]
    out = np.zeros(x.shape, np.float64)
    for ci in range(x.shape[0]):
        for bi in range(x.shape[1]):
            out[ci, bi] = np.convolve(x[ci, bi].astype(np.float64),
                                      h[ci].astype(np.float64))[:L]
    return out


@pytest.mark.parametrize("c,b,L,K", CASES)
def test_fftconv_matches_reference_kernel(c, b, L, K):
    """The port's wrapper against the reference's Pallas kernel in
    interpret mode (its default tile of 4), and both against the float64
    direct convolution.  The port's default tile is 4 where that fits a
    block (k = 128 holds one signal)."""
    x, h = conv_case(c, b, L, K, seed=L + K)
    launches = ops.LAUNCHES
    got = ops.fftconv(torch.from_numpy(x), torch.from_numpy(h))
    assert ops.LAUNCHES == launches       # a CPU tensor never launches
    assert got.shape == x.shape and got.dtype == torch.float32
    want = np.asarray(ref_ops.fftconv(jnp.asarray(x), jnp.asarray(h),
                                      interpret=True))
    assert rel_l2(got.numpy(), want) <= TOL
    exact = direct_conv(x, h)
    assert rel_l2(got.numpy(), exact) <= TOL
    assert rel_l2(want, exact) <= TOL


def _reference_kernel(x, h, n, tile_b):
    """The reference's kernel body (``fftconv_kernel`` in interpret mode)
    on the planes its wrapper builds: the signals zero-padded to n points
    and to whole tiles, the natural-order spectrum with 1/n folded in, and
    its float64 DFT matrices and twiddles cast to float32."""
    c, b, L = x.shape
    k = math.isqrt(n)
    bp = b + (-b) % tile_b
    xp = np.zeros((c, bp, n), np.float32)
    xp[:, :b, :L] = x
    hf = np.fft.fft(h.astype(np.float64), n=n, axis=-1) / n
    planes = []
    for z in (ref_tables.dft_matrix(k, False, np.complex128),
              ref_tables.dft_matrix(k, True, np.complex128),
              ref_tables.twiddles(k, k, False, np.complex128),
              ref_tables.twiddles(k, k, True, np.complex128)):
        z = np.asarray(z)
        planes += [z.real.astype(np.float32), z.imag.astype(np.float32)]
    y = ref_kernel.fftconv_kernel(
        jnp.asarray(xp.reshape(c, bp, k, k)),
        jnp.asarray(hf.real.astype(np.float32).reshape(c, k, k)),
        jnp.asarray(hf.imag.astype(np.float32).reshape(c, k, k)),
        *(jnp.asarray(p) for p in planes), k=k, tile_b=tile_b,
        interpret=True)
    return np.asarray(y).reshape(c, bp, n)[:, :b, :L]


@pytest.mark.parametrize("c,b,L,K", CASES[:3])
def test_plain_version_and_oracle_match_reference(c, b, L, K):
    """``fftconv_plain`` on the wrapper's own operands (the packed n/2-point
    Stockham FFT, the spectral pass, the same FFT on the conjugate)
    against the reference's kernel body in interpret mode, on a ragged L;
    ``fftconv_ref`` against the reference's oracle, and in float64
    against the direct convolution."""
    x, h = conv_case(c, b, L, K, seed=3 * L + K)
    op = ops.prepare(torch.from_numpy(x), torch.from_numpy(h))
    n = op.n
    mine = op.plain()
    assert mine.shape == x.shape
    theirs = _reference_kernel(x, h, n, tile_b=2)
    assert rel_l2(mine.numpy(), theirs) <= TOL
    got = ref.fftconv_ref(torch.from_numpy(x), torch.from_numpy(h), n)
    want = np.asarray(ref_ref.fftconv_ref(jnp.asarray(x), jnp.asarray(h), n))
    assert got.dtype == torch.float32
    assert rel_l2(got.numpy(), want) <= TOL
    exact = ref.fftconv_ref(torch.from_numpy(x).double(),
                            torch.from_numpy(h).double(), n)
    assert rel_l2(exact.numpy(), direct_conv(x, h)) <= 1e-12


@pytest.mark.parametrize("n", [4, 16, 256, 4096])
def test_operands_and_spectral_pass(n):
    """The operands are the kernel's: the filter's half spectrum
    rfft(h, n)/n, the Stockham schedule of the packed n/2 points and the
    roots w^k, k <= n/4.  The spectral pass turns the packed spectrum Z of
    z = x[0::2] + i x[1::2] into the conjugate of Z', whose unnormalized
    inverse packs y = irfft(X * H) for X = rfft(x), as its definition
    says."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((1, 2, n // 2 + 1)).astype(np.float32)
    h = rng.standard_normal((1, n // 2)).astype(np.float32)
    op = ops.prepare(torch.from_numpy(x), torch.from_numpy(h))
    assert op.n == n and op.hf.shape == (1, n // 2 + 1)
    np.testing.assert_allclose(op.hf.numpy(),
                               np.fft.rfft(h, n=n, axis=-1) / n, rtol=0,
                               atol=1e-6)
    assert op.tables.radices == ops.stage_schedule(n)
    assert math.prod(op.tables.radices) == n // 2
    roots = np.exp(-2j * np.pi * np.arange(n // 4 + 1) / n)
    np.testing.assert_allclose(op.tables.roots.numpy(), roots, atol=1e-7)
    x64 = np.zeros((1, 2, n))
    x64[..., :n // 2 + 1] = x
    z = np.fft.fft(x64[..., 0::2] + 1j * x64[..., 1::2], axis=-1)
    hf = np.fft.rfft(h.astype(np.float64), n=n, axis=-1) / n
    y = np.fft.irfft(np.fft.rfft(x64, axis=-1) * hf[:, None], n=n) * n
    # z' = y[0::2] + i y[1::2] is the unnormalized inverse of Z'
    want = np.conj(np.fft.fft(y[..., 0::2] + 1j * y[..., 1::2],
                              axis=-1)) / (n // 2)
    got = ref.spectral_pass(torch.from_numpy(z.astype(np.complex64)),
                            op.hf[:, None, :], op.tables.roots)
    assert rel_l2(got.numpy(), want) <= TOL


def test_next_square_pow2_matches_reference():
    for v in range(1, 20001):
        try:
            want = ref_ops._next_square_pow2(v)
        except ValueError:
            with pytest.raises(ValueError, match="n <= 16384"):
                ops._next_square_pow2(v)
            continue
        assert ops._next_square_pow2(v) == want, v
    with pytest.raises(ValueError):
        ops._next_square_pow2(16385)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32, 64, 128])
def test_every_square_side_against_direct_conv(k):
    """Each k the length rule yields, with 5 signals (a ragged last tile
    wherever 4 fit a block), one tap and (n+1)//2 taps."""
    n = k * k
    for L, K in ((n, 1), ((n + 1) // 2, (n + 1) // 2)):
        x, h = conv_case(2, 5, L, K, seed=k + K)
        assert ops._next_square_pow2(L + K - 1) == n
        got = ops.fftconv(torch.from_numpy(x), torch.from_numpy(h))
        assert rel_l2(got.numpy(), direct_conv(x, h)) <= TOL, (k, L, K)


@pytest.mark.parametrize("backend", ["xla", "stockham", "fourstep"])
@pytest.mark.parametrize("lead,L,D,K", [((), 64, 3, 7), ((2,), 100, 4, 100),
                                        ((2, 3), 33, 2, 5)])
def test_fft_fftconv_matches_reference(backend, lead, L, D, K):
    """``fft/fftconv.py``: (..., L, D) activations, (K, D) filters, every
    backend against the reference's same backend and the direct
    convolution."""
    rng = np.random.default_rng(L * D + K)
    x = rng.standard_normal((*lead, L, D)).astype(np.float32)
    h = (rng.standard_normal((K, D)) / np.sqrt(K)).astype(np.float32)
    got = port_fftconv.fftconv(torch.from_numpy(x), torch.from_numpy(h),
                               backend=backend)
    want = np.asarray(ref_fftconv.fftconv(jnp.asarray(x), jnp.asarray(h),
                                          backend=backend))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert rel_l2(got.numpy(), want) <= TOL
    xs = np.moveaxis(x, -1, -2).reshape(-1, 1, L)
    hs = np.tile(h.T, (int(np.prod(lead, dtype=int)), 1))
    exact = np.moveaxis(direct_conv(xs, hs).reshape(*lead, D, L), -1, -2)
    assert rel_l2(got.numpy(), exact) <= TOL


def test_unknown_backend_raises():
    x = torch.zeros((8, 2))
    with pytest.raises(ValueError, match="unknown fftconv backend"):
        port_fftconv.fftconv(x, x, backend="bluestein")


def test_tile_over_the_shared_memory_cap_raises():
    """An explicit tile whose block does not fit raises ValueError naming
    the cap, on any device; the default is ``DEFAULT_TILE_B`` where that
    fits."""
    x, h = conv_case(1, 4, 16384 - 127, 128, seed=1)   # n = 16384
    assert ops.largest_tile_b(16384) == 1 and ops.largest_tile_b(4096) == 6
    assert ops.largest_tile_b(1024) == ops.MAX_TILE_B
    with pytest.raises(ValueError, match=f"limit {ops.SMEM_LIMIT_BYTES}"):
        ops.fftconv(torch.from_numpy(x), torch.from_numpy(h), tile_b=2)
    x, h = conv_case(1, 8, 2048, 64, seed=2)              # n = 4096
    with pytest.raises(ValueError, match="does not fit"):
        ops.fftconv(torch.from_numpy(x), torch.from_numpy(h), tile_b=7)
    with pytest.raises(ValueError, match="does not fit"):
        ops.fftconv(torch.from_numpy(x), torch.from_numpy(h), tile_b=0)
    assert ops.prepare(torch.from_numpy(x), torch.from_numpy(h)).tile_b == \
        ops.DEFAULT_TILE_B


def test_planted_failing_build_raises_off_the_cpu(monkeypatch):
    """Off the CPU the wrapper builds and launches the kernel or raises: a
    failed build is never replaced by the plain version or torch.fft."""
    def planted(name):
        raise RuntimeError(f"planted build failure (csrc/{name}.cu)")

    monkeypatch.setattr(_build, "library", planted)
    ops._kernel.cache_clear()
    try:
        x = torch.zeros((1, 2, 100), device="meta")
        h = torch.zeros((1, 5), device="meta")
        launches = ops.LAUNCHES
        with pytest.raises(RuntimeError, match="planted build failure"):
            ops.fftconv(x, h)
        assert ops.LAUNCHES == launches
    finally:
        ops._kernel.cache_clear()
    # a built kernel is never handed host memory
    monkeypatch.setattr(ops, "_kernel", lambda: lambda *args: 0)
    cpu = ops.prepare(torch.zeros((1, 2, 100)), torch.zeros((1, 5)))
    with pytest.raises(ValueError, match="runs on cuda"):
        ops.run_kernel(cpu)
    assert ops.LAUNCHES == launches


def test_shape_errors():
    with pytest.raises(ValueError, match="x \\(C, B, L\\) and h \\(C, K\\)"):
        ops.fftconv(torch.zeros((2, 3, 8)), torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="n <= 16384"):
        ops.fftconv(torch.zeros((1, 1, 16000)), torch.zeros((1, 400)))
