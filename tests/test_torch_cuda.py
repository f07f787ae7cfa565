"""Tests of the port that need the card (marker ``cuda``).

They skip on a host without a CUDA GPU.  This file imports neither JAX nor
the reference package, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the kernel against its plain PyTorch version, rel-L2 <= 1e-5
in float and <= 1e-12 in double (the same algorithm and twiddles, only the
summation order differs); against ``torch.fft`` the suite's bar, 1e-3 and
1e-8.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.client import KINDS, TorchContext
from repro_torch.core.suite import Session, SuiteSpec
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
    """Every length class, radix and direction, with a ragged last tile
    (37 rows in tiles of 8), counting one launch per call."""
    rng = np.random.default_rng(11)
    for n in (2, 3, 12, 100, 945, 1024, 3072, ops.MAX_N[dtype]):
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
        ops.fft(torch.zeros((1, 16384), dtype=torch.complex64,
                            device=cuda_device))
    with pytest.raises(ValueError, match="tile_b"):
        ops.fft(torch.zeros((4, 4096), dtype=torch.complex64,
                            device=cuda_device), tile_b=4)


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
