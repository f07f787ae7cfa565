"""Public wrapper of the fused fftconv kernel: the square length, the
filter spectrum, the DFT matrices and twiddles (host float64, cast once to
float32), batch tiling, launch.  The kernel reads the L-point signals and
writes the L-point results itself, so nothing is padded or cut here.

``fftconv`` launches the CUDA kernel (``repro_torch/csrc/fftconv.cu``) for
tensors on the card and takes the plain version (``ref.fftconv_plain``)
only for tensors on the CPU; any other device raises.  ``prepare`` builds
the operands both read, so the kernel and its plain version can be run
(and timed) apart.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from dataclasses import dataclass

import torch

from .. import _build
from ...fft.reference import dft_matrix, twiddles
from ..stockham_pallas.ops import SMEM_LIMIT_BYTES
from .fftconv import DEFAULT_TILE_B, MAX_K, register_tile, smem_bytes
from .ref import fftconv_plain

#: Kernel launches, and launches by (channels, batch, L, K, tile_b); the
#: wrapper adds to both where it launches the kernel and nowhere else.
LAUNCHES = 0
LAUNCH_SHAPES: Counter = Counter()


def _next_square_pow2(v: int) -> int:
    """Smallest 4^m >= v (so n = k*k with k = 2^m <= 128)."""
    n = 1
    while n < v:
        n *= 4
    if n > MAX_K * MAX_K:
        raise ValueError(f"fused fftconv supports n <= 16384, need {v}")
    return n


def largest_tile_b(k: int) -> int:
    """The most signals (up to the reference's 4) one block holds at
    side ``k``."""
    return max(t for t in range(1, DEFAULT_TILE_B + 1)
               if smem_bytes(k, t) <= SMEM_LIMIT_BYTES)


def choose_tile_b(k: int, batch: int, tile_b: int | None) -> int:
    """Signals per block: ``tile_b`` (default: the largest that fits, up
    to 4), never more than the batch.  Raises ``ValueError`` when the
    block does not fit in shared memory."""
    tile = largest_tile_b(k) if tile_b is None else tile_b
    tile = min(tile, max(1, batch))
    if tile < 1 or smem_bytes(k, tile) > SMEM_LIMIT_BYTES:
        raise ValueError(f"tile_b={tile_b} does not fit one block at k={k} "
                         f"({smem_bytes(k, max(tile, 1))} bytes of shared "
                         f"memory, limit {SMEM_LIMIT_BYTES})")
    return tile


@functools.lru_cache(maxsize=32)
def _tables(k: int, device: torch.device) -> torch.Tensor:
    """(4, k, k) complex64: the forward and inverse DFT matrices and the
    forward and inverse twiddles, built in float64 and cast once."""
    c128 = torch.complex128
    return torch.stack([dft_matrix(k, False, c128, device=device),
                        dft_matrix(k, True, c128, device=device),
                        twiddles(k, k, False, c128, device=device),
                        twiddles(k, k, True, c128, device=device)]
                       ).to(torch.complex64)


@dataclass(frozen=True)
class Operands:
    """What the kernel reads, built from x (C, B, L) and h (C, K): the
    signals in float32 (C, B, L), the filter spectra (C, n), the tables
    (4, k, k)."""

    x: torch.Tensor
    hf: torch.Tensor
    tables: torch.Tensor
    k: int
    tile_b: int
    taps: int

    @property
    def shape(self) -> tuple[int, int, int, int]:
        """(C, B, L, K) of the call."""
        return (*self.x.shape, self.taps)

    def plain(self) -> torch.Tensor:
        """The kernel's plain version on the operands' device: (C, B, L)."""
        c, b, L = self.x.shape
        k = self.k
        xp = torch.nn.functional.pad(self.x, (0, k * k - L))
        w, wi, tf, ti = self.tables
        y = fftconv_plain(xp.view(c, b, k, k),
                          self.hf.real.reshape(c, k, k),
                          self.hf.imag.reshape(c, k, k), w.real, w.imag,
                          wi.real, wi.imag, tf.real, tf.imag, ti.real,
                          ti.imag)
        return y.reshape(c, b, k * k)[..., :L]


def prepare(x: torch.Tensor, h: torch.Tensor, *,
            tile_b: int | None = None) -> Operands:
    """The kernel's operands on ``x``'s device, as the reference's wrapper
    builds them: n the smallest 4^m >= L + K - 1, the filter spectrum
    ``fft(h, n) / n`` in float32 (the inverse's 1/n folded in)."""
    if x.dim() != 3 or h.dim() != 2 or h.shape[0] != x.shape[0]:
        raise ValueError(f"fftconv takes x (C, B, L) and h (C, K), got "
                         f"{tuple(x.shape)} and {tuple(h.shape)}")
    b, L = x.shape[1:]
    K = h.shape[-1]
    n = _next_square_pow2(L + K - 1)
    k = math.isqrt(n)
    tile = choose_tile_b(k, b, tile_b)
    hf = torch.fft.fft(h.to(device=x.device, dtype=torch.float32), n=n,
                       dim=-1) / n
    return Operands(x.to(torch.float32).contiguous(), hf,
                    _tables(k, x.device), k, tile, K)


def fftconv(x: torch.Tensor, h: torch.Tensor, *,
            tile_b: int | None = None) -> torch.Tensor:
    """Causal depthwise convolution through the fused kernel.

    x: (C, B, L) real activations (channel-major);  h: (C, K) real
    filters.  Returns (C, B, L), the linear causal convolution, in
    ``x``'s dtype (computed in float32).
    """
    op = prepare(x, h, tile_b=tile_b)
    y = op.plain() if x.device.type == "cpu" else run_kernel(op)
    return y.to(x.dtype)


def run_kernel(op: Operands) -> torch.Tensor:
    """Launch the kernel on prepared operands on the card: (C, B, L).
    The first call builds it; a failed build raises."""
    global LAUNCHES
    fn = _kernel()
    if op.x.device.type != "cuda":
        raise ValueError(f"the fftconv kernel runs on cuda, got {op.x.device}")
    c, b, L = op.x.shape
    y = torch.empty_like(op.x)
    if y.numel() == 0:
        return y
    with torch.cuda.device(op.x.device):
        stream = torch.cuda.current_stream(op.x.device).cuda_stream
        err = fn(op.x.data_ptr(), y.data_ptr(), op.hf.data_ptr(),
                 op.tables.data_ptr(), c, b, L, op.k, op.tile_b,
                 register_tile(op.k), stream)
    if err != 0:
        raise RuntimeError(f"fftconv kernel launch failed: cudaError_t {err} "
                           f"(channels={c}, batch={b}, length={L}, k={op.k}, "
                           f"tile_b={op.tile_b})")
    LAUNCHES += 1
    LAUNCH_SHAPES[(*op.shape, op.tile_b)] += 1
    return y


@functools.cache
def _kernel():
    """The library's entry point, its signature set once."""
    fn = _build.library("fftconv").fftconv_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn

