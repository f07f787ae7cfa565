"""The FFT roofline: modeled flops, per-device peaks and the achieved
fraction of whichever wall binds.

The reference package's ``roofline/analysis.py`` FFT part, with the
H100's envelope in place of the TPUs' (its LM formulas are not ported).
The H100 entry is the SXM data sheet's dense float32 rate outside the
tensor cores and its HBM3 rate, the same peaks ``chip_smoke.py`` bounds
every kernel by.
"""

from __future__ import annotations

import math

#: Per-device (peak FLOP/s, HBM bytes/s) envelopes for the FFT roofline,
#: keyed by a lowercase prefix of the device kind
#: (``torch.cuda.get_device_name``, or ``"cpu"``).  The ``cpu`` entry is
#: the reference's deliberately conservative host envelope, so a CPU run
#: still gives finite fractions; they compare only on one host.
DEVICE_PEAKS = {
    "cpu": (5.0e10, 2.0e10),
    "nvidia h100": (67e12, 3.35e12),
}


def device_peaks(device_kind: str | None) -> tuple[float, float]:
    """(peak FLOP/s, HBM bytes/s) for a device kind, by longest lowercase
    prefix match; an unknown kind falls back to the cpu envelope."""
    dk = (device_kind or "").lower()
    best = None
    for prefix, peaks in DEVICE_PEAKS.items():
        if dk.startswith(prefix) and (best is None or len(prefix) > best[0]):
            best = (len(prefix), peaks)
    return best[1] if best else DEVICE_PEAKS["cpu"]


def fft_model_flops(extents, batch: int = 1) -> float:
    """Modeled FFT flops: 5·N·log2(N) over the full nd problem (the log2
    factors of the axes sum, so the total-N form covers any rank) times the
    batch."""
    n = 1
    for e in extents:
        n *= int(e)
    if n <= 1:
        return 0.0
    return 5.0 * batch * n * math.log2(n)


def fft_roofline_frac(time_ms: float, flops: float, bytes_moved: float,
                      device_kind: str | None) -> float:
    """Achieved fraction of the modeled roofline for one measured FFT:
    ``max(flops / peak_flops, bytes / hbm_bw)`` over the measured time.
    Finite for a positive measurement: a non-finite or non-positive bytes
    model contributes nothing to the ideal."""
    if not time_ms or time_ms <= 0.0:
        return 0.0
    peak_flops, hbm_bw = device_peaks(device_kind)
    terms = [0.0]
    if flops and flops > 0 and flops != float("inf"):
        terms.append(flops / peak_flops)
    if bytes_moved and bytes_moved > 0 and bytes_moved != float("inf"):
        terms.append(bytes_moved / hbm_bw)
    return max(terms) / (time_ms * 1e-3)
