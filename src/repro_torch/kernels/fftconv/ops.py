"""Public wrapper of the fused fftconv kernel: the length n, the filter
half spectrum, the Stockham twiddles and R2C roots (host float64, cast once
to float32), batch tiling, launch.  The kernel reads the L-point signals
and writes the L-point results itself, so nothing is padded or cut here.

``fftconv`` launches the CUDA kernel (``repro_torch/csrc/fftconv.cu``) for
tensors on the card and takes the plain version (``ref.fftconv_plain``)
only for tensors on the CPU; any other device raises.  ``prepare`` builds
the operands both read, so the kernel and its plain version can be run
(and timed) apart.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ...fft.reference import unit_roots
from ..stockham_pallas.ops import (SMEM_LIMIT_BYTES, interleave,
                                   pack_twiddles, stage_bases)
from .fftconv import (DEFAULT_TILE_B, MAX_N, MAX_TILE_B, smem_bytes,
                      stage_schedule)
from .ref import fftconv_plain

#: Kernel launches, and launches by (channels, batch, L, K, tile_b); the
#: wrapper adds to both where it launches the kernel and nowhere else.
LAUNCHES = 0
LAUNCH_SHAPES: Counter = Counter()


def _next_square_pow2(v: int) -> int:
    """Smallest 4^m >= v (the reference's length rule: n = k*k with
    k = 2^m <= 128)."""
    n = 1
    while n < v:
        n *= 4
    if n > MAX_N:
        raise ValueError(f"fused fftconv supports n <= 16384, need {v}")
    return n


def _fits(n: int, tile: int) -> bool:
    return 1 <= tile <= MAX_TILE_B and smem_bytes(n, tile) <= SMEM_LIMIT_BYTES


def largest_tile_b(n: int) -> int:
    """The most signals (up to ``MAX_TILE_B``) one block holds at length
    ``n``."""
    return max(t for t in range(1, MAX_TILE_B + 1) if _fits(n, t))


def choose_tile_b(n: int, batch: int, tile_b: int | None) -> int:
    """Signals per block: ``tile_b`` (default: ``DEFAULT_TILE_B``, or the
    largest that fits if fewer do), never more than the batch.  Raises
    ``ValueError`` when the block does not fit."""
    tile = min(DEFAULT_TILE_B, largest_tile_b(n)) if tile_b is None else tile_b
    tile = min(tile, max(1, batch))
    if not _fits(n, tile):
        raise ValueError(f"tile_b={tile_b} does not fit one block at n={n} "
                         f"({smem_bytes(n, max(tile, 1))} bytes of shared "
                         f"memory, limit {SMEM_LIMIT_BYTES}; at most "
                         f"{MAX_TILE_B} signals)")
    return tile


@dataclass(frozen=True)
class Tables:
    """The kernel's tables at length n: the schedule of the packed n/2-point
    FFT, its packed stage twiddles, and the roots w^k = exp(-2 pi i k/n),
    k <= n/4, of the spectral pass; complex64."""

    radices: tuple[int, ...]
    bases: tuple[int, ...]
    tw: torch.Tensor
    roots: torch.Tensor


@functools.lru_cache(maxsize=32)
def _tables(n: int, device: torch.device) -> Tables:
    """Built in float64 on the host and cast once."""
    radices = stage_schedule(n)
    if not radices:
        empty = torch.zeros(1, dtype=torch.complex64, device=device)
        return Tables((), (), empty, empty)
    twr, twi, offsets = pack_twiddles(n // 2, radices, False, np.float64)
    tw = interleave(twr[0], twi[0], torch.complex64, device)
    roots = unit_roots(n, n // 4 + 1, False, torch.complex64, device=device)
    return Tables(radices, stage_bases(offsets), tw, roots)


@dataclass(frozen=True)
class Operands:
    """What the kernel reads, built from x (C, B, L) and h (C, K): the
    signals in float32 (C, B, L), the filters' half spectra (C, n/2 + 1),
    the tables at length n."""

    x: torch.Tensor
    hf: torch.Tensor
    tables: Tables
    n: int
    tile_b: int
    taps: int

    @property
    def shape(self) -> tuple[int, int, int, int]:
        """(C, B, L, K) of the call."""
        return (*self.x.shape, self.taps)

    def plain(self) -> torch.Tensor:
        """The kernel's plain version on the operands' device: (C, B, L)."""
        L = self.x.shape[-1]
        xp = torch.nn.functional.pad(self.x, (0, self.n - L))
        t = self.tables
        y = fftconv_plain(xp, self.hf, t.tw, t.radices, t.bases, t.roots)
        return y[..., :L]


def prepare(x: torch.Tensor, h: torch.Tensor, *,
            tile_b: int | None = None) -> Operands:
    """The kernel's operands on ``x``'s device, as the reference's wrapper
    builds them: n the smallest 4^m >= L + K - 1, the filter's half
    spectrum ``rfft(h, n) / n`` in float32 (the inverse's 1/n folded
    in)."""
    if x.dim() != 3 or h.dim() != 2 or h.shape[0] != x.shape[0]:
        raise ValueError(f"fftconv takes x (C, B, L) and h (C, K), got "
                         f"{tuple(x.shape)} and {tuple(h.shape)}")
    b, L = x.shape[1:]
    K = h.shape[-1]
    n = _next_square_pow2(L + K - 1)
    tile = choose_tile_b(n, b, tile_b)
    hf = torch.fft.rfft(h.to(device=x.device, dtype=torch.float32), n=n,
                        dim=-1) / n
    return Operands(x.to(torch.float32).contiguous(), hf.contiguous(),
                    _tables(n, x.device), n, tile, K)


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
        t = op.tables
        err = fn(op.x.data_ptr(), y.data_ptr(), op.hf.data_ptr(),
                 t.tw.data_ptr(), t.roots.data_ptr(), c, b, L, op.n,
                 op.tile_b, len(t.radices), _c_ints(t.radices),
                 _c_ints(t.bases), stream)
    if err != 0:
        raise RuntimeError(f"fftconv kernel launch failed: cudaError_t {err} "
                           f"(channels={c}, batch={b}, length={L}, n={op.n}, "
                           f"tile_b={op.tile_b})")
    LAUNCHES += 1
    LAUNCH_SHAPES[(*op.shape, op.tile_b)] += 1
    return y


@functools.cache
def _kernel():
    """The library's entry point, its signature set once."""
    fn = _build.library("fftconv").fftconv_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _c_ints(values: tuple[int, ...]):
    return (ctypes.c_int * max(1, len(values)))(*values)

