"""Six-step (Bailey) FFT over the hand-written kernels: the large-N path
that lifts the four-step kernel's n <= 16384 to 2^24.

Factor n = n1 * n2 and evaluate the transform as two kernel passes with
transposes between them (Bailey's six steps, hence the name):

  1. view x as A[j1, j2], transpose            -> At[j2, j1]
  2. n2 batched length-n1 FFTs (contiguous)    -> Bt[j2, k1]   stockham_pallas
  3. twiddle multiply  Bt *= W_n^{j2 k1}
  4. transpose                                 -> Ct[k1, j2]
  5. n1 batched length-n2 FFTs (contiguous)    -> D[k1, k2]    fft4step
  6. transpose + flatten: X[k1 + k2*n1] = D[k1, k2]

The length-n1 transforms run in the Stockham kernel (one block holds
every n1 <= 1024) and the length-n2 ones in the four-step kernel (one
plane in complex64; two launches in complex128 at n2 = 16384).  The
transposes and the twiddle multiply are torch ops between the launches,
as the reference does them in jnp outside its Pallas kernels.

Feasibility: power-of-two n with n1 <= ``MAX_RESIDUAL_N`` and n2 <=
``MAX_KERNEL_N2``, any power of two up to 2^24 with the default split.
numpy semantics: the inverse's 1/n comes from the two sub-transforms'
own 1/n1 and 1/n2.  A :class:`Plan` holds the device state (the n1
Stockham twiddles, the n2 four-step tables and the float64-built twiddle
grid), built once by :func:`make_plan`; ``fft`` builds none when given
one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.fft4step import ops as fourstep_ops
from ..kernels.stockham_pallas import ops as stockham_ops
from .reference import twiddles

#: The four-step kernel's cap: n2 = n2a * n2b with both factors <= 128.
MAX_KERNEL_N2 = 128 * 128

#: The residual (Stockham-side) cap.
MAX_RESIDUAL_N = 1 << 10

#: Largest extent the default split supports.
MAX_N = MAX_KERNEL_N2 * MAX_RESIDUAL_N  # 2^24


def choose_split(n: int, n1: int | None = None) -> tuple[int, int]:
    """Pick n = n1 * n2: n2 (the four-step side) as large as the kernel
    allows, n1 the power-of-two residual.  An explicit ``n1`` wins when it
    is valid for this n; otherwise the default, so one tuned knob cannot
    break other axes of an nd transform."""
    if n & (n - 1) or n < 4:
        raise ValueError(f"sixstep requires power-of-two n >= 4, got {n}")
    if n1 is not None and 2 <= n1 <= MAX_RESIDUAL_N and n % n1 == 0 \
            and (n1 & (n1 - 1)) == 0 and 2 <= n // n1 <= MAX_KERNEL_N2:
        return n1, n // n1
    k = n.bit_length() - 1
    k2 = min(14, k - 1)          # 2^14 == 16384, the four-step kernel cap
    return 1 << (k - k2), 1 << k2


def _direct(n: int) -> bool:
    """Below the smallest n1*n2 split (n = 1, 2) the Stockham kernel
    transforms the whole length: this keeps the backend usable on the
    packed-real innermost axis, whose engine length is n//2."""
    return n < 4 and (n & (n - 1)) == 0


@dataclass(frozen=True)
class Plan:
    """The device state of one length and direction: the split, the
    Stockham kernel's plan at n1 (at n itself below n = 4; None at n =
    1), the four-step kernel's tables at n2 and the twiddle grid
    T[j2, k1] = W_n^(j2 k1), shape (n2, n1) (None below n = 4)."""

    n: int
    n1: int
    n2: int
    first: stockham_ops.Twiddles | None
    second: fourstep_ops.Tables | None
    grid: torch.Tensor | None
    inverse: bool

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in (self.first, self.second)
                   if t is not None) + (
            self.grid.numel() * self.grid.element_size()
            if self.grid is not None else 0)


def make_plan(n: int, inverse: bool, dtype: torch.dtype, device,
              n1: int | None = None) -> Plan:
    """Build the plan for length ``n`` on ``device``: every table in
    float64 on the host, cast once to ``dtype`` and uploaded.  Raises for
    a length the composition does not take (over ``MAX_N``, or not a
    power of two)."""
    if n > MAX_N:
        raise ValueError(f"sixstep caps at n={MAX_N}, as the reference's "
                         f"split does; got {n}")
    if _direct(n):
        first = stockham_ops.make_twiddles(n, 8, inverse, dtype, device) \
            if n > 1 else None
        return Plan(n, n, 1, first, None, None, inverse)
    n1, n2 = choose_split(n, n1)
    return Plan(n, n1, n2,
                stockham_ops.make_twiddles(n1, 8, inverse, dtype, device),
                fourstep_ops.make_tables(n2, inverse, dtype, device),
                twiddles(n2, n1, inverse, dtype, device=device), inverse)


def _check(plan: Plan, n: int, n1: int | None, inverse: bool,
           dtype: torch.dtype, device) -> None:
    want = (n, 1) if _direct(n) else choose_split(n, n1)
    tensors = [t for t in (plan.grid, plan.first and plan.first.tw)
               if t is not None]
    if (plan.n, plan.n1, plan.n2) != (n, *want) or plan.inverse != inverse \
            or any(t.dtype != dtype or t.device != device for t in tensors):
        raise ValueError(f"sixstep plan n={plan.n} split {plan.n1}x"
                         f"{plan.n2} inverse={plan.inverse} does not match "
                         f"the call: n={n} n1={n1} {dtype} on {device} "
                         f"inverse={inverse}")


def fft(x: torch.Tensor, inverse: bool = False, *, n1: int | None = None,
        tile_b: int | None = None, plan: Plan | None = None) -> torch.Tensor:
    """Six-step FFT along the last axis through the two kernels.

    ``n1`` (the residual split) and ``tile_b`` (the batch tile of both
    kernels) are the PATIENT-searchable knobs; ``plan`` is a prebuilt
    :func:`make_plan` that must match the call.  Real input is cast to
    complex64, as the reference does.
    """
    if not x.is_complex():
        x = x.to(torch.complex64)
    n = x.shape[-1]
    if plan is None:
        plan = make_plan(n, inverse, x.dtype, x.device, n1)
    else:
        _check(plan, n, n1, inverse, x.dtype, x.device)
    if _direct(n):
        return stockham_ops.fft(x.contiguous(), inverse, tile_b=tile_b,
                                twiddles=plan.first)
    batch = x.shape[:-1]
    at = x.reshape(*batch, plan.n1, plan.n2).transpose(-1, -2).contiguous()
    bt = stockham_ops.fft(at, inverse, tile_b=tile_b,
                          twiddles=plan.first)         # length-n1 FFTs
    ct = (bt * plan.grid).transpose(-1, -2).contiguous()
    d = fourstep_ops.fft(ct, inverse, tile_b=tile_b,
                         twiddles=plan.second)         # length-n2 FFTs
    # the sub-transforms' own 1/n1 and 1/n2 compose to the inverse's 1/n
    return d.transpose(-1, -2).reshape(*batch, n)


def ifft(x: torch.Tensor) -> torch.Tensor:
    return fft(x, inverse=True)
