"""The comparison that decides ``correct``.

Every checked pair of the window is held to the plain reference, in
float64, row by row (a row is one transform of the batch):

* ``spec_err``: the forward's spectrum against the reference's transform
  of that pair's input, ``|S - ref| / |ref|`` on each row;
* ``roundtrip_err``: the inverse's output against that pair's input,
  ``|R - x| / |x|`` on each row (the reference's round trip is exact).

Each number is the worst row of the worst checked pair, so one altered
value in one row shows.  The first checked pair is the window's first:
its input is the benchmark's own, made from the seed.  Later checked
pairs take as input what the pair before them left, the inverse's output,
as the Table-1 loop feeds it; the reference takes that input as given.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

#: Elements of one block of rows the reference holds at once.
BLOCK_ELEMS = 1 << 23


@dataclass
class Checked:
    """One checked pair: when in the window it is due, the shift of the
    batch's rows before it, its input (None for the first, whose input is
    the benchmark's own), spectrum and round trip, and its index in the
    window once taken."""

    at_s: float
    shift: int
    x: torch.Tensor | None
    s: torch.Tensor
    r: torch.Tensor
    pair: int | None = None


def _row_rel(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-row ``|out - ref| / |ref|`` in float64."""
    wide = torch.complex128 if ref.is_complex() else torch.float64
    o = out.to(wide).reshape(out.shape[0], -1)
    r = ref.to(wide).reshape(ref.shape[0], -1)
    den = torch.linalg.vector_norm(r, dim=1)
    num = torch.linalg.vector_norm(o - r, dim=1)
    return num / torch.clamp(den, min=torch.finfo(torch.float64).tiny)


def errors(dft, x0: torch.Tensor, pairs: list[Checked]) -> list[dict]:
    """``spec_err`` and ``roundtrip_err`` of each checked pair; NaN where
    an output is not finite."""
    out = []
    for c in pairs:
        x = x0 if c.x is None else c.x
        step = max(1, BLOCK_ELEMS // max(1, x[0].numel()))
        spec = rt = torch.zeros((), dtype=torch.float64, device=x.device)
        for b in range(0, x.shape[0], step):
            xb = x[b: b + step]
            # torch.maximum keeps a NaN, where max() would drop it
            spec = torch.maximum(spec, _row_rel(c.s[b: b + step],
                                                dft.forward(xb)).max())
            rt = torch.maximum(rt, _row_rel(c.r[b: b + step], xb).max())
        out.append({"pair": c.pair, "spec_err": float(spec),
                    "roundtrip_err": float(rt)})
    return out
