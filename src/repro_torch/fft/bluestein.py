"""Bluestein chirp-Z FFT for arbitrary (incl. large-prime) lengths: the
paper's "oddshape" extents (powers of 19, Fig. 7).

Identity: with jk = (j^2 + k^2 - (k-j)^2) / 2,

    X[k] = c[k] * sum_j (x[j] c[j]) * conj(c)[k - j],   c[j] = e^{-i pi j^2 / n}

a linear convolution of a[j] = x[j] c[j] with b[j] = conj(c)[j], evaluated
circularly at a padded size m >= 2n - 1: next_pow2(2n - 1) for the
power-of-two engines, the smallest 7-smooth m for the mixed-radix
Stockham kernel.

Engines (the planner's ``chirpz_pallas`` backend against the staged
``bluestein`` baseline): the two padded transforms run through the
Stockham kernel (``stockham_pallas``), the six-step composition
(``sixstep``) for padded lengths past ``PALLAS_SINGLE_MAX_M``, or the
staged plain-torch ``stockham``.  ``engine="auto"`` picks by padded length
with the reference's thresholds for a tensor on the card, and the staged
engine on the CPU (the reference's interpret-mode branch); an explicit
engine forces the kernels anywhere.

The chirp c and the padded filter spectrum FFT(b) depend only on (n, m,
dtype, direction): they are built once on the host in float64 (the
filter by an exact numpy DFT, so the third transform of the classical
form never runs) and memoized (:func:`chirp_tables`, bounded).  j^2 is
reduced mod 2n in integer arithmetic before the float conversion, so the
phases stay accurate for n in the millions.  Real input widens to the
complex dtype of its width: float32 -> complex64, float64 -> complex128.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core.extents import next_pow2 as _next_pow2, next_smooth
from ..kernels.stockham_pallas import ops as stockham_ops
from . import sixstep, stockham

#: Padded-length thresholds of ``engine="auto"``: the Stockham kernel up
#: to this m, the six-step composition beyond, the staged engine past the
#: six-step cap (the reference's values).
PALLAS_SINGLE_MAX_M = 1 << 15
SIXSTEP_MAX_M = 1 << 24

#: Engines the ``engine`` knob accepts ("auto" resolves by padded length).
ENGINES = ("auto", "stockham", "stockham_pallas", "sixstep")

#: (n, m, dtype name, inverse) -> (chirp, padded filter spectrum), host
#: arrays.  Bounded: a near-cap complex128 entry is ~400 MB, so a long
#: oddshape sweep evicts the oldest problems first.
_TABLES: dict = {}
_TABLES_MAX = 32


def resolve_engine(n: int, engine: str = "auto",
                   cpu: bool = False) -> tuple[str, int]:
    """Resolve the ``engine`` knob and the padded length m >= 2n - 1 it
    convolves at.  The Stockham kernel takes any 7-smooth m, so it pads
    tighter than the power-of-two engines.  With ``cpu`` (a tensor on the
    CPU) "auto" keeps the staged engine; an explicit engine forces the
    kernels anywhere."""
    lo = 2 * n - 1
    if engine == "auto":
        if cpu:
            engine = "stockham"
        elif next_smooth(lo) <= PALLAS_SINGLE_MAX_M:
            engine = "stockham_pallas"
        elif _next_pow2(lo) <= SIXSTEP_MAX_M:
            engine = "sixstep"
        else:
            engine = "stockham"
    if engine not in ENGINES:
        raise ValueError(f"chirp engine must be one of {ENGINES}, "
                         f"got {engine!r}")
    m = next_smooth(lo) if engine == "stockham_pallas" else _next_pow2(lo)
    return engine, m


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 -> c64, f64 -> c128; complex dtypes pass through."""
    if dtype.is_complex:
        return dtype
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _build_tables(n: int, m: int, dtype: torch.dtype, inverse: bool):
    """The host float64 chirp and padded filter spectrum (exact numpy
    DFT), cast once to ``dtype``'s numpy twin."""
    j = np.arange(n, dtype=np.int64)
    jsq_mod = (j * j) % (2 * n)  # exact integer reduction
    ang = np.pi * jsq_mod.astype(np.float64) / n
    c = np.exp((1j if inverse else -1j) * ang)
    # b[j] = conj(c)[|j|] placed circularly: b[0..n-1] and b[m-n+1..m-1]
    bc = np.conj(c)
    b = np.zeros(m, dtype=np.complex128)
    b[:n] = bc
    b[m - n + 1:] = bc[1:][::-1]
    fb = np.fft.fft(b)
    dt = np.dtype(str(dtype).removeprefix("torch."))
    return c.astype(dt), fb.astype(dt)


def chirp_tables(n: int, m: int, dtype: torch.dtype, inverse: bool = False):
    """The (chirp, filter spectrum) host pair for one (n, m, dtype,
    direction), memoized so a repeated build does no host trig work."""
    key = (n, m, str(dtype).removeprefix("torch."), bool(inverse))
    out = _TABLES.get(key)
    if out is None:
        while len(_TABLES) >= _TABLES_MAX:
            _TABLES.pop(next(iter(_TABLES)))
        out = _TABLES[key] = _build_tables(n, m, dtype, inverse)
    return out


def _engine_plan(engine: str, m: int, inverse: bool, dtype: torch.dtype,
                 device) -> Any:
    """The padded engine's device state for one direction at length m
    (none for the staged engine, which caches its own stage twiddles)."""
    if engine == "stockham_pallas":
        return stockham_ops.make_twiddles(m, 8, inverse, dtype, device)
    if engine == "sixstep":
        return sixstep.make_plan(m, inverse, dtype, device)
    return None


@dataclass(frozen=True)
class Plan:
    """A chirp-Z transform's device state: the resolved engine and padded
    length, the chirp (n,), the filter spectrum (m,), and the padded
    engine's plans for its forward and inverse transforms."""

    n: int
    m: int
    engine: str
    inverse: bool
    chirp: torch.Tensor
    spectrum: torch.Tensor
    forward: Any
    backward: Any

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.chirp, self.spectrum)) + sum(
            p.nbytes for p in (self.forward, self.backward) if p is not None)


def make_plan(n: int, inverse: bool, dtype: torch.dtype, device,
              engine: str = "stockham") -> Plan:
    """Build the plan for length ``n`` on ``device`` (``engine`` resolved
    for the device, see :func:`resolve_engine`)."""
    device = torch.device(device)
    engine, m = resolve_engine(n, engine, cpu=device.type == "cpu")
    c, fb = chirp_tables(n, m, dtype, inverse)
    return Plan(n, m, engine, inverse,
                torch.from_numpy(c).to(device), torch.from_numpy(fb).to(device),
                _engine_plan(engine, m, False, dtype, device),
                _engine_plan(engine, m, True, dtype, device))


def _padded(plan: Plan, tile_b: int | None):
    """cfft(v, inverse) for the two padded length-m transforms."""
    if plan.engine == "stockham":
        return stockham.fft
    if plan.engine == "stockham_pallas":
        return lambda v, inverse=False: stockham_ops.fft(
            v, inverse, tile_b=tile_b,
            twiddles=plan.backward if inverse else plan.forward)
    return lambda v, inverse=False: sixstep.fft(
        v, inverse, tile_b=tile_b,
        plan=plan.backward if inverse else plan.forward)


def fft(x: torch.Tensor, inverse: bool = False, *, engine: str = "stockham",
        tile_b: int | None = None, plan: Plan | None = None) -> torch.Tensor:
    """Chirp-Z DFT along the last axis; works for any length n.

    ``engine`` selects the padded engine ("stockham" keeps the staged
    baseline; "auto", "stockham_pallas" and "sixstep" are the kernel path
    the planner exposes as ``chirpz_pallas``); ``engine`` and ``tile_b``
    are the PATIENT-searchable knobs.  ``plan`` is a prebuilt
    :func:`make_plan` for this length, dtype, device and direction.
    """
    x = x.to(_complex_dtype(x.dtype))
    n = x.shape[-1]
    if n == 1:
        return x
    if plan is None:
        plan = make_plan(n, inverse, x.dtype, x.device, engine)
    elif (plan.n != n or plan.inverse != inverse
          or plan.chirp.dtype != x.dtype or plan.chirp.device != x.device):
        raise ValueError(f"chirp-Z plan n={plan.n} inverse={plan.inverse} "
                         f"{plan.chirp.dtype} on {plan.chirp.device} does "
                         f"not match the call: n={n} inverse={inverse} "
                         f"{x.dtype} on {x.device}")
    cfft = _padded(plan, tile_b)
    a = torch.zeros((*x.shape[:-1], plan.m), dtype=x.dtype, device=x.device)
    a[..., :n] = x * plan.chirp
    conv = cfft(cfft(a) * plan.spectrum, inverse=True)
    y = conv[..., :n] * plan.chirp
    if inverse:
        y = y / n
    return y


def ifft(x: torch.Tensor) -> torch.Tensor:
    return fft(x, inverse=True)
