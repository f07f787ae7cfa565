"""The plain reference against numpy.fft, and its control's precision."""

import _paths  # noqa: F401
import numpy as np
import pytest
import torch

from perfbench.reference import dft


def _signal(shape, real, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    return x if real else x + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("extents", [(19,), (64,), (4096,), (9,), (8, 6),
                                     (19, 5)])
@pytest.mark.parametrize("real", [False, True])
def test_reference_matches_numpy(extents, real):
    x = _signal((3, *extents), real)
    ref = dft.Dft(extents, real=real)
    axes = tuple(range(-len(extents), 0))
    want = np.fft.rfftn(x, axes=axes) if real else np.fft.fftn(x, axes=axes)
    got = ref.forward(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    back = ref.inverse(torch.from_numpy(want)).numpy()
    if real:
        want_back = np.fft.irfftn(want, s=extents, axes=axes)
    else:
        want_back = np.fft.ifftn(want, axes=axes)
    assert back.shape == want_back.shape
    assert np.abs(back - want_back).max() <= 1e-12 * np.abs(x).max()


@pytest.mark.parametrize("precision,lo,hi", [("tf32", 1e-5, 3e-3),
                                             ("float32", 1e-9, 1e-5)])
@pytest.mark.parametrize("real", [False, True])
def test_control_precision(precision, lo, hi, real):
    """The control sits where its precision puts it: TF32 (10 mantissa
    bits) near 2^-11 relative, float32 near 2^-24."""
    x = _signal((8, 256), real, seed=1)
    want = np.fft.rfft(x) if real else np.fft.fft(x)
    src = torch.from_numpy(x).to(torch.float32 if real else torch.complex64)
    got = dft.Dft((256,), real=real, precision=precision).forward(src).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert lo < rel < hi


def test_tf32_rounding_keeps_ten_bits():
    t = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, -3.0 - 2 ** -9, 0.0])
    assert dft._tf32(t).tolist() == [1.0 + 2 ** -10, 1.0, -3.0 - 2 ** -9, 0.0]


def test_unknown_precision_refused():
    with pytest.raises(ValueError):
        dft.Dft((8,), real=False, precision="bfloat16")
