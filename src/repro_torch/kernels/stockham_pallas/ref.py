"""Plain PyTorch versions of the Stockham kernel, on any device.

* :func:`apply_stages` repeats the kernel's arithmetic with the kernel's own
  packed twiddles, one stage per pass over memory.  ``ops.fft`` takes it for
  tensors that lie on the CPU.
* :func:`apply_passes` repeats the one-block kernel's register passes:
  the stages grouped as ``block.block_layout`` groups them, each pass a
  radix-R stage (R = RA*RB) computed as its two stages on the points a
  thread holds.  ``ops.fft`` takes it for tensors that lie on the CPU.
* :func:`run_block` runs a ``block.Layout`` as the CUDA kernel does, index
  by index: work units, FastDiv, padded shared-memory layouts, the real
  folds' paired butterflies (the R2C post-pass, the C2R pre-pass).  The
  tests hold it against numpy; it is the kernel's model, not a fast path.
* :func:`apply_two_pass` repeats the two column passes of an axis over the
  one-block cap (n = n1*n2): the n1-point column FFTs with the pass
  twiddle W_n^(j2*k1) from the plan's root tables, then the n2-point ones,
  stored in natural order.
* :func:`stockham_ref` is the independent oracle: the same recursion with
  its twiddles computed here, as the reference package's ``ref.py`` does, so
  a kernel-vs-oracle comparison isolates the kernel, not the factorization.
"""

from __future__ import annotations

import numpy as np
import torch

from . import block
from .stockham_pallas import radix_schedule


def _butterfly_roots(r: int, inverse: bool) -> list[complex]:
    sign = 2.0 if inverse else -2.0
    return [complex(w) for w in
            np.exp(1j * (sign * np.pi / r) * np.arange(r, dtype=np.float64))]


def _stage(v: torch.Tensor, r: int, inverse: bool, twiddle) -> torch.Tensor:
    """One radix-r stage on ``v`` viewed as (..., r, m, s); ``twiddle(u)``
    gives the (m,) stage twiddles of output u >= 1."""
    w = _butterfly_roots(r, inverse)
    rows = []
    for u in range(r):
        acc = v[..., 0, :, :]
        for t in range(1, r):
            acc = acc + v[..., t, :, :] * w[(t * u) % r]
        if u:
            acc = acc * twiddle(u)[:, None]
        rows.append(acc)
    return torch.stack(rows, dim=-2)          # (..., m, r, s)


def apply_stages(x: torch.Tensor, tw: torch.Tensor,
                 radices: tuple[int, ...], bases: tuple[int, ...],
                 inverse: bool) -> torch.Tensor:
    """The kernel's stage chain along the last axis of complex ``x``, with
    the packed twiddles ``tw`` (stage twiddle of (u, p) at
    ``bases[stage] + (u-1)*m + p``).  No 1/n scaling."""
    lead, n = x.shape[:-1], x.shape[-1]
    cur = n
    for r, base in zip(radices, bases):
        m = cur // r
        v = x.reshape(*lead, r, m, n // cur)
        x = _stage(v, r, inverse,
                   lambda u, b=base, m=m: tw[b + (u - 1) * m:b + u * m]
                   ).reshape(*lead, n)
        cur = m
    return x


def apply_passes(x: torch.Tensor, tw: torch.Tensor,
                 radices: tuple[int, ...], bases: tuple[int, ...],
                 groups: tuple[int, ...], inverse: bool) -> torch.Tensor:
    """The kernel's register passes along the last axis of complex ``x``:
    ``groups`` cuts the schedule into passes of one or two stages; a pass
    of radices (ra, rb) at stride s views the row as x[q + s (p + M t)], t
    = t2 + rb t1, runs the ra-point stage over t1 (twiddles W_cur^((p + M
    t2) u1) at ``bases[i] + (u1-1) M rb + p + M t2``), then the rb-point
    stage over t2 (W^(p u2) at ``bases[i+1] + (u2-1) M + p``), and stores
    output u1 + ra u2 at q + s (u1 + ra u2 + R p).  No 1/n scaling."""
    lead, n = x.shape[:-1], x.shape[-1]
    i, s = 0, 1
    for g in groups:
        ra = radices[i]
        rb = radices[i + 1] if g == 2 else 1
        R = ra * rb
        M = n // (R * s)
        # x[q + s (p + M (t2 + rb t1))] as (t1, t2 p, q): stage A over t1
        # at the positions p + M t2
        ma, b = M * rb, bases[i]
        v = _stage(x.reshape(*lead, ra, ma, s), ra, inverse,
                   lambda u, b=b, ma=ma: tw[b + (u - 1) * ma:b + u * ma])
        v = v.reshape(*lead, rb, M, ra, s)                  # (t2, p, u1, q)
        # (p + M t2, u1, q) -> stage B over t2, for each (u1, q)
        v = v.movedim(-2, -4)                               # (u1, t2, p, q)
        if rb > 1:
            b = bases[i + 1]
            v = torch.stack([
                _stage(v[..., u1, :, :, :], rb, inverse,
                       lambda u, b=b, M=M: tw[b + (u - 1) * M:b + u * M])
                for u1 in range(ra)], dim=-4)               # (u1, p, u2, q)
            v = v.movedim(-4, -2)                            # (p, u2, u1, q)
        else:
            v = v[..., 0, :, :].movedim(-3, -2).unsqueeze(-3)  # (p, 1, u1, q)
        x = v.reshape(*lead, n)
        s *= R
        i += g
    return x


def _dft(v: torch.Tensor, r: int, inverse: bool) -> torch.Tensor:
    """The r-point DFT along dim 0 of ``v`` (r, ...)."""
    if r == 1:
        return v
    w = torch.as_tensor(np.array(_butterfly_roots(r, inverse)), dtype=v.dtype,
                        device=v.device)
    e = torch.as_tensor(np.outer(np.arange(r), np.arange(r)) % r)
    return torch.tensordot(w[e], v, dims=1)


def _pass_stages(a: torch.Tensor, p: block.Pass, tw: torch.Tensor,
                 pidx: torch.Tensor, inverse: bool) -> torch.Tensor:
    """``pass_stages`` of the kernel on a (R, units) tensor of points; the
    output k = u1 + ra u2 ends in row u2 + rb u1.  A power-of-two pass of
    16 or more points forms stage A's twiddle as the table's W_cur^(p u1)
    times the float64 constant W_R^(t2 u1), as the kernel does."""
    ra, rb, M = p.ra, p.rb, p.M
    factor = p.R >= 16 and p.R & (p.R - 1) == 0
    sign = 2.0 if inverse else -2.0
    a = a.clone()
    for t2 in range(rb):
        rows = [t2 + rb * t1 for t1 in range(ra)]
        v = _dft(a[rows], ra, inverse)
        if p.base_a >= 0:
            for u1 in range(1, ra):
                if factor:
                    c = complex(np.exp(1j * sign * np.pi * (t2 * u1 % p.R)
                                       / p.R))
                    w = tw[p.base_a + (u1 - 1) * M * rb + pidx] * \
                        torch.tensor(c, dtype=tw.dtype)
                else:
                    w = tw[p.base_a + (u1 - 1) * M * rb + pidx + M * t2]
                v[u1] = v[u1] * w
        a[rows] = v
    if rb > 1:
        for u1 in range(ra):
            rows = [t2 + rb * u1 for t2 in range(rb)]
            v = _dft(a[rows], rb, inverse)
            if p.base_b >= 0:
                for u2 in range(1, rb):
                    v[u2] = v[u2] * tw[p.base_b + (u2 - 1) * M + pidx]
            a[rows] = v
    return a


def _slot(p: block.Pass, k: int) -> int:
    return k // p.ra + p.rb * (k % p.ra)


def run_block(x: torch.Tensor, layout: block.Layout, tw: torch.Tensor,
              inverse: bool, roots: torch.Tensor | None = None,
              out_shape: tuple[int, ...] | None = None,
              out_dtype: torch.dtype | None = None, scale: float = 1.0,
              nyq: int = 0, in_sig: int = 0, in_row: int = 0,
              out_sig: int = 0, out_row: int = 0) -> torch.Tensor:
    """``block_fft`` over ``x`` (signals along dim 0, flattened), block by
    block, with the kernel's own index arithmetic (``block.fdiv``), work
    units, pads and paired butterflies; asserts what the kernel assumes
    (an in-place pass has no more units than threads).  ``out_shape`` /
    ``out_dtype`` give the output (the input's by default); the remaining
    arguments are those of ``Layout.struct`` and the launch."""
    L = layout
    mode = L.mode
    sig_pts = L.n1 * L.l2
    batch = x.shape[0]
    xf = x.reshape(batch, -1)
    y = torch.zeros(out_shape or x.shape, dtype=out_dtype or x.dtype)
    yf = y.reshape(y.shape[0], -1)
    cdt = tw.dtype
    sm = torch.zeros(2 * L.points + L.points + 64, dtype=cdt)
    for sig0 in range(0, batch, L.tile):
        sigs = min(L.tile, batch - sig0)
        sm.zero_()
        for i, p in enumerate(L.passes):
            first, last = i == 0, i == len(L.passes) - 1
            in_off, out_off = L.offsets(i)
            in_sh = L.shifts[i - 1] if i > 0 else block.NO_PAD
            out_sh = L.shifts[i] if i < len(L.shifts) else block.NO_PAD
            upg = p.units(L.n1)
            units = sigs * upg
            u = torch.arange(units)
            sig = block.fdiv(block.fast_div(upg), u)
            rest = u - sig * upg
            pad = lambda e, sh: e + (e >> sh)
            R = p.R
            if p.paired:
                h0 = p.B // 2 + 1
                mid = (p.A // 2 - 1) * p.B
                v = (rest - h0).clamp_min(0)
                if p.col:   # the column fastest
                    step = max(1, p.A // 2 - 1)
                    a1 = block.fdiv(block.fast_div(step), v)
                    in_mid_alpha, in_mid_beta = 1 + v - a1 * step, a1
                else:       # the butterfly fastest
                    a1 = block.fdiv(block.fast_div(p.B), v)
                    in_mid_alpha, in_mid_beta = 1 + a1, v - a1 * p.B
                alpha = torch.where((p.A == 1) | (rest < h0), 0, torch.where(
                    rest < h0 + mid, in_mid_alpha, p.A // 2))
                beta = torch.where((p.A == 1) | (rest < h0), rest, torch.where(
                    rest < h0 + mid, in_mid_beta, rest - h0 - mid))
                alpha2 = torch.where(alpha > 0, p.A - alpha, 0)
                beta2 = torch.where(beta > 0, p.B - beta, 0)
                self_ = (alpha2 == alpha) & (beta2 == beta)
                sides = []
                for al, be in ((alpha, beta), (alpha2, beta2)):
                    line = sig if p.col else sig * L.n1 + al
                    c = al if p.col else torch.zeros_like(al)
                    q, pp = (torch.zeros_like(be), be) if inverse else \
                        (be, torch.zeros_like(be))
                    sides.append((al, line, c, q, pp))
                k1_of = lambda al, j: j if p.col else al
                k2_of = lambda al, j: al if p.col else j
                a = []
                if inverse:       # the pre-pass from the bins
                    yv = []
                    for al, line, c, q, pp in sides:
                        j = pp[None, :] + p.M * torch.arange(R)[:, None]
                        k1, k2 = k1_of(al[None, :], j), k2_of(al[None, :], j)
                        idx = (sig0 + sig)[None, :] * in_sig + k1 * in_row + k2
                        yv.append(xf.reshape(-1)[idx])
                    a = [yv[0].clone(), yv[1].clone()]
                    for m in range(2):
                        al, line, c, q, pp = sides[m]
                        for t in range(R):
                            tm = torch.where(beta > 0, R - 1 - t, (R - t) % R)
                            j = pp + p.M * t
                            k1, k2 = k1_of(al, j), k2_of(al, j)
                            nq = ((sig0 + sig) * in_sig + ((L.n1 - k1) & (L.n1 - 1))
                                  * in_row + nyq)
                            mirror = yv[1 - m].gather(
                                0, tm[None, :]).squeeze(0)
                            g = torch.where(k2 == 0, xf.reshape(-1)[nq],
                                            mirror).conj()
                            e = 0.5 * (yv[m][t] + g)
                            o = 0.5 * (yv[m][t] - g) * roots[k2]
                            a[m][t] = torch.complex(e.real - o.imag,
                                                    e.imag + o.real)
                else:
                    for al, line, c, q, pp in sides:
                        eb = line * p.L * p.C + c + p.C * q
                        e = eb[None, :] + p.C * p.s * torch.arange(R)[:, None]
                        if first:
                            a.append(xf.reshape(-1)[sig0 * sig_pts + e])
                        else:
                            a.append(sm[in_off + pad(e, in_sh)])
                a = [_pass_stages(a[m], p, tw, sides[m][4], inverse)
                     for m in range(2)]
                if inverse:
                    for m in range(2):
                        keep = torch.ones_like(self_) if m == 0 else ~self_
                        al, line, c, q, pp = sides[m]
                        for k in range(R):
                            e = line * p.L * p.C + c + p.C * (k + R * pp)
                            v = a[m][_slot(p, k)]
                            if last:
                                yf.reshape(-1)[(sig0 * sig_pts + e)[keep]] = \
                                    (v * scale)[keep]
                            else:
                                sm[(out_off + pad(e, out_sh))[keep]] = v[keep]
                else:
                    for m in range(2):
                        keep = torch.ones_like(self_) if m == 0 else ~self_
                        al, line, c, q, pp = sides[m]
                        for k in range(R):
                            j = q + p.s * k
                            k1, k2 = k1_of(al, j), k2_of(al, j)
                            z = a[m][_slot(p, k)]
                            km = torch.where(beta > 0, _slot(p, R - 1 - k),
                                             _slot(p, (R - k) % R))
                            zm = a[1 - m].gather(0, km[None, :]).squeeze(0)
                            d = z - zm.conj()
                            e = 0.5 * (z + zm.conj())
                            o = torch.complex(0.5 * d.imag, -0.5 * d.real)
                            base = (sig0 + sig) * out_sig + k1 * out_row
                            flat = yf.reshape(-1)
                            flat[(base + k2)[keep]] = (e + roots[k2] * o)[keep]
                            nq = keep & (k2 == 0)
                            flat[(base + nyq)[nq]] = (e - o)[nq]
                continue
            if not first and not last and in_off == out_off:
                assert units <= L.threads, (i, units, L.threads)
            if p.col:
                j = block.fdiv(block.fast_div(p.C), rest)
                c = rest - j * p.C
                line = sig
            else:
                r = block.fdiv(block.fast_div(p.nb), rest)
                j = rest - r * p.nb
                c = torch.zeros_like(j)
                line = sig * L.n1 + r
            pp = block.fdiv(block.fast_div(p.s), j)
            q = j - pp * p.s
            t = torch.arange(R)[:, None]
            e_in = (line * p.L * p.C + c + p.C * (q + p.s * pp))[None, :] \
                + p.C * p.s * p.M * t
            flat_in = xf.reshape(-1)
            if not first:
                a = sm[in_off + pad(e_in, in_sh)]
            elif mode == block.ODD and not inverse:
                a = flat_in[sig0 * sig_pts + e_in].to(cdt)
            elif mode == block.ODD:
                k = pp[None, :] + p.M * t
                row = (sig0 + line)[None, :] * in_sig
                a = torch.where(k <= nyq, flat_in[row + k.clamp(max=nyq)],
                                flat_in[row + (L.l2 - k).clamp(0, nyq)].conj())
            else:
                a = flat_in[sig0 * sig_pts + e_in]
            a = _pass_stages(a, p, tw, pp, inverse)
            for k in range(R):
                e = line * p.L * p.C + c + p.C * (q + p.s * (k + R * pp))
                v = a[_slot(p, k)]
                flat = yf.reshape(-1)
                if not last:
                    sm[out_off + pad(e, out_sh)] = v
                elif mode == block.ODD and not inverse:
                    b = q + p.s * k
                    keep = b <= nyq
                    flat[((sig0 + line) * out_sig + b)[keep]] = v[keep]
                elif mode == block.ODD:
                    flat[sig0 * sig_pts + e] = (v.real * scale).to(flat.dtype)
                else:
                    flat[sig0 * sig_pts + e] = v * scale if inverse else v
    return y


def pass_twiddle(roots: torch.Tensor, e: torch.Tensor,
                 lo: int = 1024) -> torch.Tensor:
    """W_n^e from the two-pass root tables (``ops.pass_roots``): hi[e //
    lo] * lo[e % lo], in the tables' dtype, as the kernel forms it."""
    return roots[lo + torch.div(e, lo, rounding_mode="floor")] * roots[e % lo]


def apply_two_pass(x: torch.Tensor, n1: int, n2: int, first, second,
                   roots: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The kernel's two passes along the last axis of complex ``x`` (length
    n1*n2): the n1-point FFTs of the columns x[j1*n2 + j2], each output k1
    times W_n^(j2*k1); then the n2-point FFTs over j2, output k2 of row k1
    at y[k1 + n1*k2].  ``first`` and ``second`` are each pass's (packed
    twiddles, radices, bases).  No 1/n scaling."""
    lead = x.shape[:-1]
    cols = x.reshape(*lead, n1, n2).transpose(-1, -2)        # (j2, j1)
    a = apply_stages(cols, *first, inverse)                  # (j2, k1)
    e = torch.outer(torch.arange(n2, device=x.device),
                    torch.arange(n1, device=x.device))
    a = a * pass_twiddle(roots, e)
    b = apply_stages(a.transpose(-1, -2), *second, inverse)  # (k1, k2)
    return b.transpose(-1, -2).reshape(*lead, n1 * n2)


def stockham_ref(x: torch.Tensor, radix: int = 8,
                 inverse: bool = False) -> torch.Tensor:
    """General-radix Stockham FFT along the last axis (7-smooth length),
    the kernel's schedule with twiddles computed here in float64.  Forward
    unnormalized, inverse applies 1/n (numpy semantics)."""
    if not x.is_complex():
        x = x.to(torch.complex64)
    lead, n = x.shape[:-1], x.shape[-1]
    sign = 2.0 if inverse else -2.0
    cur = n
    for r in radix_schedule(n, radix):
        m = cur // r
        p = np.arange(m, dtype=np.int64)

        def twiddle(u, cur=cur, p=p):
            ang = (sign * np.pi / cur) * ((u * p) % cur).astype(np.float64)
            return torch.as_tensor(np.exp(1j * ang), dtype=x.dtype,
                                   device=x.device)

        x = _stage(x.reshape(*lead, r, m, n // cur), r, inverse,
                   twiddle).reshape(*lead, n)
        cur = m
    if inverse:
        x = x / n
    return x
