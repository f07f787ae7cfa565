"""Public wrapper of the fused Stockham kernel: schedule, twiddle packing
(host float64), shared-memory sizing, launch, normalization.

``fft`` launches the CUDA kernel (``repro_torch/csrc/stockham.cu``) for a
tensor on the card and takes the plain version (``ref.apply_stages``) only
for a tensor on the CPU.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from .ref import apply_stages
from .stockham_pallas import radix_schedule, smooth7

#: Shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT_BYTES = 232448

#: Shared memory the default batch tile aims for: small enough that several
#: blocks share an SM.
SMEM_TARGET_BYTES = 32 << 10

_CDTYPES = (torch.complex64, torch.complex128)

#: Kernel launches, and launches by (n, rows, dtype); wrappers add to both
#: where they launch the kernel and nowhere else.
LAUNCHES = 0
LAUNCH_SHAPES: Counter = Counter()


def smem_bytes(n: int, tile_b: int, itemsize: int, n_stages: int) -> int:
    """Dynamic shared memory of one block: two ping-pong buffers of
    ``tile_b`` rows, or none for a single-stage schedule (global in, global
    out).  ``itemsize`` is the complex element size."""
    return 2 * tile_b * n * itemsize if n_stages > 1 else 0


def _largest_fitting(itemsize: int) -> int:
    n = SMEM_LIMIT_BYTES // (2 * itemsize)
    while not smooth7(n):
        n -= 1
    return n


#: Longest axis one block can hold (tile_b = 1, two buffers in shared
#: memory): 14406 = 2*3*7^4 for complex64, 7203 = 3*7^4 for complex128.
#: Longer axes belong to the six-step path, not to this kernel.
MAX_N = {torch.complex64: _largest_fitting(8),
         torch.complex128: _largest_fitting(16)}


def check_length(n: int, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` for a length the kernel cannot take."""
    if not smooth7(n):
        raise ValueError("stockham_pallas requires a 7-smooth "
                         f"(2^a*3^b*5^c*7^d) length, got {n}")
    if n > MAX_N[dtype]:
        raise ValueError(f"stockham_pallas caps at n={MAX_N[dtype]} for "
                         f"{dtype} (Hopper shared memory per block); got {n}")


def pack_twiddles(n: int, radices: tuple[int, ...], inverse: bool,
                  real_dtype) -> tuple[np.ndarray, np.ndarray,
                                       tuple[tuple[int, ...], ...]]:
    """Per-stage twiddle planes W_cur^{p*u} (u = 1..r-1, p < cur/r) packed
    into one (1, L) pair plus per-(stage, u) offsets, in the reference
    package's exact layout (zero-padded to a multiple of 128).

    Angles use exact integer reduction of p*u mod cur before the float64
    conversion, so float32 twiddles stay accurate at any length.
    """
    sign = 2.0 if inverse else -2.0
    re_chunks, im_chunks, offsets = [], [], []
    off, cur = 0, n
    for r in radices:
        m = cur // r
        stage_offs = []
        p = np.arange(m, dtype=np.int64)
        for u in range(1, r):
            ang = (sign * np.pi / cur) * ((u * p) % cur).astype(np.float64)
            re_chunks.append(np.cos(ang))
            im_chunks.append(np.sin(ang))
            stage_offs.append(off)
            off += m
        offsets.append(tuple(stage_offs))
        cur = m
    pad = (-off) % 128 or (128 if off == 0 else 0)
    re_chunks.append(np.zeros(pad))
    im_chunks.append(np.zeros(pad))
    twr = np.concatenate(re_chunks)[None, :].astype(real_dtype)
    twi = np.concatenate(im_chunks)[None, :].astype(real_dtype)
    return twr, twi, tuple(offsets)


@dataclass(frozen=True)
class Twiddles:
    """A plan's device state: the schedule and its packed twiddles as one
    interleaved complex vector (``pack_twiddles`` without its padding).
    ``inverse`` is None when every twiddle is 1 (a single-stage schedule
    serves both directions)."""

    n: int
    radices: tuple[int, ...]
    bases: tuple[int, ...]
    tw: torch.Tensor
    inverse: bool | None

    @property
    def nbytes(self) -> int:
        return self.tw.numel() * self.tw.element_size()


def stage_bases(offsets: tuple[tuple[int, ...], ...]) -> tuple[int, ...]:
    """Each stage's base in the packed vector (its u = 1 offset), from
    ``pack_twiddles``' per-(stage, u) offsets."""
    return tuple(o[0] for o in offsets)


def packed_length(radices: tuple[int, ...]) -> int:
    """Twiddles one axis' schedule uses, without ``pack_twiddles``'
    padding."""
    length, cur = 0, int(np.prod(radices))
    for r in radices:
        cur //= r
        length += (r - 1) * cur
    return length


def direction_of(twi: np.ndarray) -> bool | None:
    """The direction a packed imaginary plane was built for, or None when
    every twiddle is 1 (a single-stage schedule serves both directions):
    the first stage with m > 1 holds W_cur^1 at its p = 1 slot, whose
    imaginary part has the transform's sign."""
    nontrivial = np.flatnonzero(np.abs(twi) > 0)
    return bool(twi[nontrivial[0]] > 0) if nontrivial.size else None


def interleave(twr: np.ndarray, twi: np.ndarray, dtype: torch.dtype,
               device) -> torch.Tensor:
    """Real and imaginary planes as one interleaved complex vector of
    ``dtype`` on ``device``."""
    planes = np.stack([twr, twi], axis=-1)
    tw = torch.view_as_complex(torch.from_numpy(np.ascontiguousarray(planes)))
    return tw.to(device=device, dtype=dtype)


def _from_planes(twr: np.ndarray, twi: np.ndarray,
                 offsets: tuple[tuple[int, ...], ...], dtype: torch.dtype,
                 device) -> Twiddles:
    radices = tuple(len(o) + 1 for o in offsets)
    length = packed_length(radices)
    return Twiddles(int(np.prod(radices)), radices, stage_bases(offsets),
                    interleave(twr[0, :length], twi[0, :length], dtype,
                               device),
                    direction_of(twi[0, :length]))


def make_twiddles(n: int, radix: int, inverse: bool, dtype: torch.dtype,
                  device) -> Twiddles:
    """Build the plan for length ``n`` on ``device``: schedule, twiddles in
    float64 on the host, cast once to ``dtype``'s precision and uploaded."""
    check_length(n, dtype)
    radices = radix_schedule(n, radix)
    real = np.float64 if dtype == torch.complex128 else np.float32
    return _from_planes(*pack_twiddles(n, radices, inverse, real), dtype,
                        device)


def twiddles_from_reference(twr: np.ndarray, twi: np.ndarray,
                            offsets: tuple[tuple[int, ...], ...],
                            device) -> Twiddles:
    """The port's plan from the reference package's ``pack_twiddles``
    output: same values, same stage bases, padding dropped."""
    dtype = torch.complex128 if twr.dtype == np.float64 else torch.complex64
    return _from_planes(twr, twi, offsets, dtype, device)


def default_tile_b(n: int, batch: int, itemsize: int, n_stages: int) -> int:
    """Rows per block: as many as fill ``SMEM_TARGET_BYTES`` (at least
    one), never more than the batch."""
    per_row = max(1, smem_bytes(n, 1, itemsize, max(n_stages, 2)))
    return max(1, min(batch, SMEM_TARGET_BYTES // per_row))


def fft(x: torch.Tensor, inverse: bool = False, *, tile_b: int | None = None,
        radix: int = 8, twiddles: Twiddles | None = None) -> torch.Tensor:
    """Fused Stockham FFT along the last axis.

    7-smooth lengths up to ``MAX_N[dtype]``; numpy semantics (the inverse
    applies 1/n).  Real input is cast to complex64.  ``tile_b`` and
    ``radix`` are the tunable knobs; ``twiddles`` is a prebuilt plan
    (``make_twiddles``) that must match the call's length, schedule,
    dtype, device and direction.
    """
    if not x.is_complex():
        x = x.to(torch.complex64)
    if x.dtype not in _CDTYPES:
        raise TypeError(f"stockham_pallas takes complex64/complex128, got {x.dtype}")
    n = x.shape[-1]
    check_length(n, x.dtype)
    if n == 1:
        return x   # length-1 DFT is the identity (1/n factor is 1 too)
    if twiddles is None:
        twiddles = make_twiddles(n, radix, inverse, x.dtype, x.device)
    elif (twiddles.n != n or twiddles.radices != radix_schedule(n, radix)
          or twiddles.tw.dtype != x.dtype or twiddles.tw.device != x.device
          or twiddles.inverse not in (None, inverse)):
        raise ValueError("twiddles do not match this call: plan "
                         f"n={twiddles.n} radices={twiddles.radices} "
                         f"{twiddles.tw.dtype} on {twiddles.tw.device} "
                         f"inverse={twiddles.inverse}; call n={n} "
                         f"radix={radix} {x.dtype} on {x.device} "
                         f"inverse={inverse}")
    if x.device.type == "cpu":
        y = apply_stages(x, twiddles.tw, twiddles.radices, twiddles.bases,
                         inverse)
        return y / n if inverse else y
    if x.device.type != "cuda":
        raise ValueError(f"stockham_pallas runs on cuda or cpu, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("stockham_pallas needs a contiguous tensor "
                         "(the transformed axis last, unit stride)")
    return _launch(x, inverse, tile_b, twiddles)


@functools.cache
def _kernel(dtype: torch.dtype):
    """The library's entry point for ``dtype``, its signature set once."""
    lib = _build.library("stockham")
    fn = lib.stockham_fft_f64 if dtype == torch.complex128 \
        else lib.stockham_fft_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _c_ints(values: tuple[int, ...]):
    return (ctypes.c_int * len(values))(*values)


def _launch(x: torch.Tensor, inverse: bool, tile_b: int | None,
            twiddles: Twiddles) -> torch.Tensor:
    global LAUNCHES
    n = x.shape[-1]
    rows = x.numel() // n
    y = torch.empty_like(x)
    if rows == 0:
        return y
    itemsize = x.element_size()
    n_stages = len(twiddles.radices)
    tile = tile_b if tile_b is not None else default_tile_b(
        n, rows, itemsize, n_stages)
    tile = min(tile, rows)
    if tile < 1 or smem_bytes(n, tile, itemsize, n_stages) > SMEM_LIMIT_BYTES \
            or tile * n >= 1 << 30:
        raise ValueError(f"tile_b={tile_b} does not fit one block for n={n} "
                         f"{x.dtype} (shared memory limit "
                         f"{SMEM_LIMIT_BYTES} bytes)")
    fn = _kernel(x.dtype)
    radices, bases = _c_ints(twiddles.radices), _c_ints(twiddles.bases)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), twiddles.tw.data_ptr(), rows, n,
                 tile, int(inverse), n_stages, radices, bases, stream)
    if err != 0:
        raise RuntimeError(f"stockham kernel launch failed: cudaError_t {err} "
                           f"(n={n}, rows={rows}, tile_b={tile}, {x.dtype})")
    LAUNCHES += 1
    LAUNCH_SHAPES[(n, rows, str(x.dtype).removeprefix("torch."))] += 1
    return y
