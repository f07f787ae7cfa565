"""The port's R2C packing and separable ND layer against the reference's.

The same numpy inputs go through ``repro.fft.rfft``/``repro.fft.nd`` with
the reference's ``stockham_pallas`` kernel (Pallas interpret mode) as the
engine, and through ``repro_torch.fft.rfft``/``repro_torch.fft.nd`` with the
port's ``stockham_pallas`` wrapper (its plain version on CPU tensors).

Tolerance: rel-L2 <= 1e-5 in float, <= 1e-12 in double.  Both sides run
the same algorithm with the same float64-computed twiddles, so only the
summation order differs.
"""

import numpy as np
import pytest
import torch

from helpers.accuracy import rel_l2

from repro.fft import nd as ref_nd
from repro.fft import reference as ref_reference
from repro.fft import rfft as ref_rfft
from repro.kernels.stockham_pallas import ops as sp_ops
from repro_torch.fft import nd, reference, rfft
from repro_torch.kernels.stockham_pallas import ops

TOL = {"float": 1e-5, "double": 1e-12}
REAL = {"float": np.float32, "double": np.float64}
CPLX = {"float": np.complex64, "double": np.complex128}


def ref_engine(precision):
    # complex128 at tile 1: see test_torch_stockham.py for the reference's
    # interpret-mode fault at larger tiles
    tile = None if precision == "float" else 1
    return lambda x, inverse=False: sp_ops.fft(x, inverse=inverse,
                                               tile_b=tile, interpret=True)


def port_engine(x, inverse=False):
    return ops.fft(x, inverse)


def inputs(shape, precision, seed):
    rng = np.random.default_rng(seed)
    xr = rng.standard_normal(shape).astype(REAL[precision])
    xc = (rng.standard_normal(shape) +
          1j * rng.standard_normal(shape)).astype(CPLX[precision])
    return xr, xc


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("n", [16, 15, 12, 9])
def test_rfft_irfft(n, precision):
    """Even lengths take the half-length pack, odd ones the full complex
    transform; the inverse takes the reference's spectrum."""
    xr, _ = inputs((3, n), precision, seed=n)
    want = np.array(ref_rfft.rfft(xr, ref_engine(precision)))
    got = rfft.rfft(torch.from_numpy(xr), port_engine)
    assert got.shape == want.shape == (3, n // 2 + 1)
    assert rel_l2(got, want) <= TOL[precision]
    back_want = np.array(ref_rfft.irfft(want, n, ref_engine(precision)))
    back = rfft.irfft(torch.from_numpy(want), n, port_engine)
    assert back.dtype == torch.from_numpy(xr).dtype
    assert rel_l2(back, back_want) <= TOL[precision]
    assert rel_l2(back, xr) <= TOL[precision] * 10
    if n % 2 == 0:   # a plan's prebuilt pack tables give the same result
        cd = got.dtype
        fwd = reference.half_roots(n, False, cd, device="cpu")
        inv = reference.half_roots(n, True, cd, device="cpu")
        assert torch.equal(rfft.rfft(torch.from_numpy(xr), port_engine, fwd),
                           got)
        assert torch.equal(rfft.irfft(torch.from_numpy(want), n, port_engine,
                                      inv), back)


SHAPES = [(16,), (15,), (8, 12), (6, 9), (4, 4, 8), (2, 3, 5)]


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fftn_rfftn_irfftn(shape, precision):
    """Ranks 1-3 over a leading batch axis: complex forward and inverse,
    real forward, real inverse of the reference's spectrum."""
    batch_shape = (2, *shape)
    axes = tuple(range(-len(shape), 0))
    xr, xc = inputs(batch_shape, precision, seed=sum(shape))
    eng = ref_engine(precision)

    want = np.array(ref_nd.fftn(xc, eng, axes=axes))
    got = nd.fftn(torch.from_numpy(xc), port_engine, axes=axes)
    assert rel_l2(got, want) <= TOL[precision]
    want_inv = np.array(ref_nd.fftn(want, eng, axes=axes, inverse=True))
    got_inv = nd.fftn(torch.from_numpy(want), port_engine, axes=axes,
                      inverse=True)
    assert rel_l2(got_inv, want_inv) <= TOL[precision]

    spec = np.array(ref_nd.rfftn(xr, eng, axes=axes))
    got_spec = nd.rfftn(torch.from_numpy(xr), port_engine, axes=axes)
    assert got_spec.shape == spec.shape
    assert rel_l2(got_spec, spec) <= TOL[precision]
    back = np.array(ref_nd.irfftn(spec, shape, eng, axes=axes))
    got_back = nd.irfftn(torch.from_numpy(spec), shape, port_engine, axes=axes)
    assert tuple(got_back.shape) == batch_shape
    assert rel_l2(got_back, back) <= TOL[precision]


def test_per_axis_engines_and_minimal_swaps():
    """A sequence of engines maps one per axis; the engine always receives
    a contiguous last axis."""
    seen = []

    def spy(x, inverse=False):
        assert x.is_contiguous()
        seen.append(x.shape[-1])
        return port_engine(x, inverse)

    x = torch.from_numpy(inputs((2, 4, 6, 8), "double", seed=1)[1])
    got = nd.fftn(x, [spy, spy, spy], axes=(-3, -2, -1))
    assert seen == [4, 6, 8]
    assert rel_l2(got, np.fft.fftn(x.numpy(), axes=(-3, -2, -1))) <= 1e-12
    with pytest.raises(ValueError):
        nd.fftn(x, [spy, spy], axes=(-3, -2, -1))


@pytest.mark.parametrize("precision", ["float", "double"])
def test_reference_tables_and_wrappers(precision):
    """The host float64 twiddle tables are bit-identical to the
    reference's; the torch.fft wrappers keep its conventions."""
    cd = {"float": torch.complex64, "double": torch.complex128}[precision]
    for inverse in (False, True):
        for got, want in (
                (reference.dft_matrix(12, inverse, cd, device="cpu"),
                 ref_reference.dft_matrix(12, inverse, CPLX[precision])),
                (reference.twiddles(4, 6, inverse, cd, device="cpu"),
                 ref_reference.twiddles(4, 6, inverse, CPLX[precision])),
                (reference.half_roots(30, inverse, cd, device="cpu"),
                 ref_reference.half_roots(30, inverse, CPLX[precision]))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(TypeError, match="device"):
        reference.half_roots(30, False, cd)   # no default device
    xr, xc = inputs((3, 6, 10), precision, seed=2)
    axes = (-2, -1)
    pairs = (
        (reference.fftn(torch.from_numpy(xc), axes),
         ref_reference.fftn(xc, axes)),
        (reference.ifft(torch.from_numpy(xc)), ref_reference.ifft(xc)),
        (reference.rfftn(torch.from_numpy(xr), axes),
         ref_reference.rfftn(xr, axes)),
        (reference.irfftn(torch.from_numpy(np.array(ref_reference.rfftn(xr, axes))),
                          (6, 10), axes),
         ref_reference.irfftn(ref_reference.rfftn(xr, axes), (6, 10), axes)),
    )
    for got, want in pairs:
        assert rel_l2(got, np.asarray(want)) <= TOL[precision]
