"""Host side of the one-block kernels' register passes (``block_fft`` in
``repro_torch/csrc/stockham_stages.cuh``), shared by the Stockham and the
fused rank-2 kernels and their real-input folds.

A block owns ``tile`` signals of n1 rows by l2 points (n1 = 1 for a 1-D
signal).  ``block_layout`` groups each axis' stages into passes of one or
two stages (a pass of R = RA*RB points a thread) that one kernel's case
family holds (``family_cases``), chooses its threads, places the layouts
between passes in one shared buffer (two only where a pass that reads and
writes shared memory has more butterflies than threads to hold them
across the barrier) and pads each layout, element e at e + (e >> sh), with
the shift that a bank model finds conflict-free.  ``Layout.struct`` is the
kernel's ``BlockPlan``.

Nothing here touches a device: the tests run it on the CPU, and
``ref.run_block`` executes a layout in torch, index by index, as the
kernel does.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, replace

import numpy as np

#: The pass cases (RA, RB), in the order of ``REPRO_PASS_CASES`` in
#: ``csrc/stockham_stages.cuh``: the identity pass of a one-point axis, one
#: stage of each radix, and every two consecutive stages a schedule holds
#: (odd radices first, then the power-of-two work radix and its cleanup).
PASS_CASES = ((1, 1), (2, 1), (3, 1), (4, 1), (5, 1), (7, 1), (8, 1),
              (7, 7), (7, 5), (7, 3), (7, 8), (7, 4), (7, 2), (5, 5), (5, 3),
              (5, 8), (5, 4), (5, 2), (3, 3), (3, 8), (3, 4), (3, 2), (8, 8),
              (8, 4), (8, 2), (4, 4), (4, 2), (2, 2))
_CODE = {rr: i for i, rr in enumerate(PASS_CASES)}

#: The kernels' case families (``family_cases`` in
#: ``csrc/stockham_stages.cuh``): a kernel inlines its family's cases into
#: one switch and ptxas allocates one set of registers for all of them,
#: so a family holds a few cases that fit 255 registers together.
SMALL_POW2, ODD_RADIX, BIG, ONE_STAGE = 0, 1, 2, 3
#: The families in the order a plan prefers them, at equal passes: the
#: fewest registers first.
FAMILIES = (ONE_STAGE, SMALL_POW2, ODD_RADIX, BIG)
_SINGLES = frozenset({0, 1, 3, 6})           # 1, 2, 4, 8
_ODD_SINGLES = frozenset({2, 4, 5})          # 3, 5, 7
_POW2_PAIRS16 = frozenset({24, 25, 26, 27})  # 8x2, 4x4, 4x2, 2x2
_ODD_PAIRS16 = frozenset({12, 14, 17, 18, 20, 21})

def max_threads(family: int, itemsize: int) -> int:
    """Threads a block of a family's kernel may have (``family_threads``):
    512 for the one-stage family in complex64 (at most 128 registers a
    thread), 256 for the others (up to 255)."""
    return 512 if family == ONE_STAGE and itemsize == 8 else 256


def family_cases(family: int, itemsize: int, paired: bool) -> frozenset:
    """The pass codes (``PASS_CASES`` indices) of a family's kernel for
    complex ``itemsize``: unpaired passes, or a fold's paired pass (two
    butterflies, so half the points)."""
    dbl = itemsize == 16
    if family == SMALL_POW2:
        return _SINGLES | (frozenset({26, 27}) if paired else _POW2_PAIRS16)
    if family == ODD_RADIX:
        if paired or dbl:
            return _SINGLES | _ODD_SINGLES | (frozenset() if dbl
                                                else frozenset({21}))
        return _SINGLES | _ODD_SINGLES | _ODD_PAIRS16
    if family == BIG and not dbl:
        return _SINGLES if paired else _SINGLES | frozenset({22})
    if family == ONE_STAGE and not paired:
        return _SINGLES | _ODD_SINGLES
    return frozenset()


#: The pad shift that means no pad (e >> 31 is 0 for any index).
NO_PAD = 31
#: Pad shifts the bank model tries: none first, then the sparsest pads.
PAD_SHIFTS = (NO_PAD,) + tuple(range(12, 3, -1))
#: Warps of a pass the bank model follows.
MODEL_WARPS = 4

#: Shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT_BYTES = 232448

#: The kernels' ``MODE``: complex, an even last extent's fold (paired
#: passes), an odd length's fold.
C2C, EVEN, ODD = 0, 1, 2
MAX_PASSES = 16


def fast_div(d: int) -> tuple[int, int, int]:
    """(d, mul, shr) with n // d == (mulhi(n, mul) + n) >> shr for 0 <= n
    < 2^31: ``FastDiv`` of the kernel."""
    if not 1 <= d < 1 << 31:
        raise ValueError(f"divisor {d} out of range")
    shr = (d - 1).bit_length()
    mul = ((1 << 32) * ((1 << shr) - d)) // d + 1
    return d, mul, shr


def fdiv(f: tuple[int, int, int], n):
    """The kernel's ``fdiv`` on non-negative ints (or int64 arrays)."""
    _, mul, shr = f
    return (((n * mul) >> 32) + n) >> shr


@dataclass(frozen=True)
class Pass:
    """One register pass: radices (ra, rb) (rb = 1: one stage), the line
    form (``col``: C interleaved columns of a signal; else rows), line
    length L, interleave C, entry stride s, M = L / (R s) and the twiddle
    bases of its stages (-1: all ones).  A paired pass (a fold's first
    pass, inverse, or last, forward) takes each butterfly with its mirror
    over (alpha < A, beta < B): the signal's rows (n1) or columns (C), and
    its butterflies p (the first pass, s = 1) or q (the last, M = 1)."""

    ra: int
    rb: int
    col: bool
    L: int
    C: int
    s: int
    M: int
    base_a: int
    base_b: int
    paired: bool = False
    A: int = 1
    B: int = 1

    @property
    def R(self) -> int:
        return self.ra * self.rb

    @property
    def nb(self) -> int:
        return self.L // self.R

    def units(self, n1: int) -> int:
        """Work units of one signal: butterflies, or mirror pairs."""
        if not self.paired:
            return (self.C if self.col else n1) * self.nb
        half = self.B // 2 + 1
        return half if self.A == 1 else 2 * half + (self.A // 2 - 1) * self.B

    def with_pairing(self, n1: int, side: str) -> "Pass":
        """This pass paired on the load side (``first``) or the store side
        (``last``)."""
        return replace(self, paired=True, A=self.C if self.col else n1,
                       B=self.M if side == "first" else self.s)


def _axis_passes(radices: tuple[int, ...], bases: tuple[int, ...],
                 groups: tuple[int, ...], col: bool, L: int, C: int
                 ) -> list[Pass]:
    """The passes of one axis (schedule ``radices``, twiddle ``bases``) in
    ``groups`` of consecutive stages (each 1 or 2)."""
    out, i, s = [], 0, 1
    for g in groups:
        ra = radices[i]
        rb = radices[i + 1] if g == 2 else 1
        R = ra * rb
        M = L // (R * s)
        base_a = bases[i] if M * rb > 1 else -1
        base_b = (bases[i + 1] if M > 1 else -1) if g == 2 else -1
        out.append(Pass(ra, rb, col, L, C, s, M, base_a, base_b))
        s *= R
        i += g
    return out


@functools.lru_cache(maxsize=None)
def _groupings(k: int) -> tuple[tuple[int, ...], ...]:
    """Every way to cut k stages into consecutive groups of one or two."""
    if k == 0:
        return ((),)
    out = [(1,) + g for g in _groupings(k - 1)]
    if k >= 2:
        out += [(2,) + g for g in _groupings(k - 2)]
    return tuple(out)


def _addresses(p: Pass, n1: int, units: int, write: bool) -> np.ndarray:
    """Tile-linear shared-memory indices of a pass's loads (or stores) by
    the first ``units`` work units, as the unpaired kernel maps them:
    (points, units)."""
    u = np.arange(units)
    upg = (p.C if p.col else n1) * p.nb
    sig, rest = np.divmod(u, upg)
    if p.col:
        j, c = np.divmod(rest, p.C)
        line = sig
    else:
        r, j = np.divmod(rest, p.nb)
        c = np.zeros_like(j)
        line = sig * n1 + r
    pp, q = np.divmod(j, p.s)
    t = np.arange(p.R)[:, None]
    if write:
        eb = line * p.L * p.C + c + p.C * (q + p.s * p.R * pp)
        return eb[None, :] + p.C * p.s * t
    eb = line * p.L * p.C + c + p.C * (q + p.s * pp)
    return eb[None, :] + p.C * p.s * p.M * t


def wavefronts(addr: np.ndarray, itemsize: int) -> int:
    """Shared-memory wavefronts of warp accesses: ``addr`` (points, lanes)
    distinct element indices, lane order; a warp's 8-byte accesses go in
    two phases of 16 lanes over 16 bank pairs, 16-byte ones in four of 8
    over 8; a phase takes as many wavefronts as the most lanes on one bank
    slot."""
    group = 128 // itemsize
    pts, lanes = addr.shape
    pad = (-lanes) % 32
    if pad:
        addr = np.concatenate([addr, np.full((pts, pad), -1)], axis=1)
    phases = addr.reshape(-1, group)
    live = phases >= 0
    onehot = (phases[..., None] % group == np.arange(group)) & live[..., None]
    return int(onehot.sum(axis=1).max(axis=1).sum())


def _bank_cost(writer: Pass, reader: Pass, n1: int, tile: int, sh: int,
               itemsize: int) -> int:
    total = 0
    for p, write in ((writer, True), (reader, False)):
        units = min(tile * (p.C if p.col else n1) * p.nb, MODEL_WARPS * 32)
        a = _addresses(p, n1, units, write)
        total += wavefronts(a + (a >> sh) if sh != NO_PAD else a, itemsize)
    return total


@dataclass(frozen=True)
class Layout:
    """A launch of ``block_fft``: the passes, the kernel's case family, its
    threads, the shared buffers (0, 1 or 2), the pad shift of the layout
    after each pass but the last, and the dynamic shared memory."""

    n1: int
    l2: int
    tile: int
    mode: int
    passes: tuple[Pass, ...]
    family: int
    threads: int
    buffers: int
    shifts: tuple[int, ...]
    smem: int

    @property
    def points(self) -> int:
        return self.n1 * self.l2 * self.tile

    def offsets(self, i: int) -> tuple[int, int]:
        """Shared-memory offsets (elements) pass ``i`` reads and writes."""
        if self.buffers < 2:
            return 0, 0
        return ((i - 1) % 2) * self.points, (i % 2) * self.points

    def struct(self, nyq: int = 0, in_sig: int = 0, in_row: int = 0,
               out_sig: int = 0, out_row: int = 0) -> "BlockPlanC":
        """The kernel's ``BlockPlan``; a fold's Nyquist index and the
        strides of its bins."""
        bp = BlockPlanC()
        bp.n_passes = len(self.passes)
        bp.n1, bp.l2, bp.tile, bp.nyq = self.n1, self.l2, self.tile, nyq
        bp.mode = self.mode
        bp.in_sig, bp.in_row, bp.out_sig, bp.out_row = (in_sig, in_row,
                                                        out_sig, out_row)
        for i, p in enumerate(self.passes):
            d = bp.passes[i]
            in_off, out_off = self.offsets(i)
            d.code = _CODE[(p.ra, p.rb)]
            d.col = int(p.col)
            d.L, d.C, d.s, d.M, d.nb = p.L, p.C, p.s, p.M, p.nb
            d.upg = p.units(self.n1)
            d.base_a, d.base_b = p.base_a, p.base_b
            d.in_off, d.out_off = in_off, out_off
            d.in_sh = self.shifts[i - 1] if i > 0 else NO_PAD
            d.out_sh = self.shifts[i] if i < len(self.shifts) else NO_PAD
            d.A, d.B = p.A, p.B
            # a paired pass's middle units: the column form takes the
            # column fastest (divide by A/2 - 1), the row form the
            # butterfly (divide by B)
            f_b = max(1, p.A // 2 - 1) if p.col else p.B
            for name, v in (("f_upg", d.upg), ("f_nb", p.nb), ("f_c", p.C),
                            ("f_s", p.s), ("f_b", f_b)):
                setattr(d, name, FastDivC(*fast_div(v)))
        return bp


class FastDivC(ctypes.Structure):
    _fields_ = [("d", ctypes.c_uint), ("mul", ctypes.c_uint),
                ("shr", ctypes.c_uint)]


class PassDescC(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in (
        "code", "col", "L", "C", "s", "M", "nb", "upg", "base_a", "base_b",
        "in_off", "out_off", "in_sh", "out_sh", "A", "B")] + [
        (name, FastDivC) for name in ("f_upg", "f_nb", "f_c", "f_s", "f_b")]


class BlockPlanC(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in (
        "n_passes", "n1", "l2", "tile", "nyq", "mode")] + [
        (name, ctypes.c_longlong) for name in (
            "in_sig", "in_row", "out_sig", "out_row")] + [
        ("passes", PassDescC * MAX_PASSES)]


def entry(fn) -> object:
    """Set the argument types of a library's one-block entry (``fn``:
    ``stockham_block_f32`` and the like): x, y, tw, roots, plan, signals,
    inverse, family, scale, threads, shared memory, stream."""
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.POINTER(BlockPlanC),
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_double, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _family(passes: list[Pass], itemsize: int) -> int | None:
    """The first family (``FAMILIES``' order) whose kernel holds every
    pass, or None."""
    for family in FAMILIES:
        if all(_CODE[(p.ra, p.rb)] in family_cases(family, itemsize, p.paired)
               for p in passes):
            return family
    return None


@functools.lru_cache(maxsize=4096)
def group_passes(n1: int, l2: int, row_radices: tuple[int, ...],
                 row_bases: tuple[int, ...], col_radices: tuple[int, ...],
                 col_bases: tuple[int, ...], tile: int, itemsize: int,
                 mode: int = C2C, inverse: bool = False
                 ) -> tuple[tuple[Pass, ...], int, int, int]:
    """The passes of ``tile`` signals of n1 x l2 points: the row stages
    (the l2 axis; ``row_radices`` with their twiddle bases) then the column
    stages (the n1 axis), grouped one or two a pass; with the kernel's
    family, its threads and its buffers (0: one pass, global in and out).
    A grouping is feasible when one family holds all its passes
    and, for one buffer, when every pass between the first and the last
    has no more butterflies than threads.  The threads match the passes'
    work in points (a tail of small butterflies loops) and every in-place
    pass's butterflies.  The best feasible one: one buffer before two,
    then the fewest passes, then the smallest largest pass, then the
    family of fewest registers."""
    paired_side = None
    if mode == EVEN:
        paired_side = "first" if inverse else "last"
    best = None
    for rg in _groupings(len(row_radices)):
        rows = _axis_passes(row_radices, row_bases, rg, False, l2, 1)
        for cg in _groupings(len(col_radices)):
            passes = rows + _axis_passes(col_radices, col_bases, cg, True,
                                         n1, l2)
            if not passes:
                passes = [Pass(1, 1, False, 1, 1, 1, 1, -1, -1)]
            if paired_side is not None:
                i = 0 if paired_side == "first" else -1
                passes[i] = passes[i].with_pairing(n1, paired_side)
            family = _family(passes, itemsize)
            if family is None:
                continue
            units = [tile * p.units(n1) for p in passes]
            largest = max(p.R * (2 if p.paired else 1) for p in passes)
            # threads for the passes' work in points, and for every
            # in-place pass's butterflies
            work = max(-(-u * p.R * (2 if p.paired else 1) // largest)
                       for u, p in zip(units, passes))
            most = max([work] + units[1:-1])
            threads = max(32, min(max_threads(family, itemsize),
                                  -(-most // 32) * 32))
            buffers = 0 if len(passes) == 1 else (
                1 if all(u <= threads for u in units[1:-1]) else 2)
            key = (buffers == 2, len(passes), largest,
                   FAMILIES.index(family))
            if best is None or key < best[0]:
                best = (key, tuple(passes), family, threads, buffers)
    if best is None:
        raise ValueError(f"no register passes for {n1}x{l2} in the kernel "
                         "families")
    return best[1:]


@functools.lru_cache(maxsize=4096)
def block_layout(n1: int, l2: int, row_radices: tuple[int, ...],
                 row_bases: tuple[int, ...], col_radices: tuple[int, ...],
                 col_bases: tuple[int, ...], tile: int, itemsize: int,
                 mode: int = C2C, inverse: bool = False) -> Layout:
    """The launch of ``tile`` signals of n1 x l2 points: ``group_passes``,
    a pad shift for each layout between two passes (the bank model's
    cheapest; none in two buffers) and the shared memory.  Raises
    ``ValueError`` when the tile's shared memory exceeds the limit."""
    passes, family, threads, buffers = group_passes(
        n1, l2, row_radices, row_bases, col_radices, col_bases, tile,
        itemsize, mode, inverse)
    pts = n1 * l2 * tile
    shifts = []
    for i in range(len(passes) - 1):
        if buffers == 2:
            shifts.append(NO_PAD)
            continue
        costs = [(_bank_cost(passes[i], passes[i + 1], n1, tile, sh,
                             itemsize), sh) for sh in PAD_SHIFTS]
        shifts.append(min(costs, key=lambda c: c[0])[1])
    if buffers == 2:
        smem = 2 * pts * itemsize
    elif buffers == 1:
        smem = max(pts + ((pts - 1) >> sh) for sh in shifts) * itemsize
    else:
        smem = 0
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"{tile} signals of {n1}x{l2} points need {smem} "
                         f"bytes of shared memory (limit {SMEM_LIMIT_BYTES})")
    return Layout(n1, l2, tile, mode, tuple(passes), family, threads,
                  buffers, tuple(shifts), smem)
