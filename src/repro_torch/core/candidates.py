"""The planner's candidate space: backends, feasibility on Hopper, and
enumeration.

The backend keys are the reference package's (``xla``,
``stockham_pallas``, ...), and :meth:`Candidate.key` renders the same plan
keys, per-axis ``nd[...]`` ones included, so a plan the reference or a
wisdom record selected runs the same schedule here
(:meth:`Candidate.from_key`).  Feasibility is the reference's: each
kernel takes what the reference's takes (Stockham 7-smooth n <= 2^20, the
four-step kernel n1, n2 <= 128, fft2 n1*n2 <= 2^18), running as passes
through global memory where one block's 227 KB of shared memory does not
hold the signal (:func:`kernel_passes`); the six-step composition takes
powers of two 4 ... 2^24 and the chirp-Z path any n <= 2^23.  The PATIENT
grid offers only the knobs a kernel honors at the problem's shape.
Enumeration prunes per-axis assignments by the active cost model
(:mod:`.costmodel`), imported lazily as in the reference.  The
distributed decompositions (:data:`DIST_BACKENDS`: ``dist1d``, ``slab``,
``pencil``, over ``fft/distributed.py``) are offered only over a mesh:
the caller's, or the active one (``launch.mesh.set_active_mesh``).
"""

from __future__ import annotations

import itertools
import re
from dataclasses import dataclass
from typing import Any, Sequence

from .client import Problem
from .extents import _factors_only, next_pow2 as _next_pow2, next_smooth

_KEY = re.compile(
    r"^([A-Za-z_][A-Za-z0-9_]*)(?:\[(\d+(?:x\d+)*)\])?(?:\((.*)\))?$")

#: Whole-transform backends: one engine call covers every axis, so the
#: separable path's transpose traffic never happens.
FUSED_ND = ("xla", "fft2_pallas")

#: Every backend the port's planner knows, in the reference's enumeration
#: (preference-tie) order.
BACKENDS = ("xla", "stockham", "fourstep", "dft", "fourstep_pallas",
            "stockham_pallas", "sixstep", "fft2_pallas", "chirpz_pallas",
            "bluestein")

#: Mesh-sharded decompositions (``fft/distributed.py``), enumerated only
#: over a mesh and kept out of :data:`BACKENDS`, so single-device planning
#: and the support matrix are the same without one.
DIST_BACKENDS = ("dist1d", "slab", "pencil")

#: all_to_alls per decomposition in the default TRANSPOSED-output layout.
DIST_A2A_COUNT = {"dist1d": 2, "slab": 1, "pencil": 2}
#: Extra all_to_alls for natural-order output.
DIST_NATURAL_EXTRA = {"dist1d": 1, "slab": 1, "pencil": 2}

#: The six-step composition's lengths (``fft/sixstep.py``: n1 <= 2^10
#: over the four-step kernel's n2 <= 2^14).
SIXSTEP_MIN_N, SIXSTEP_MAX_N = 4, 1 << 24
#: Longest chirp-Z length whose padded transform (next_pow2(2n-1)) the
#: six-step composition still takes.
CHIRPZ_PALLAS_MAX_N = 1 << 23


@dataclass(frozen=True)
class Candidate:
    """One point in the planner's search space: a backend with its knobs
    (``options``, in key order) applied to every axis, or -- when ``axes``
    is non-empty -- a per-axis assignment with the placeholder backend
    ``'nd'``: ``axes[i]`` transforms ``extents[i]``, outermost first.
    ``mesh`` is a distributed candidate's mesh shape (``slab[4]``,
    ``pencil[2x4]``): a selection tuned for one device count means nothing
    for another, in plan-cache keys and in wisdom alike."""

    backend: str
    options: tuple[tuple[str, Any], ...] = ()
    axes: tuple["Candidate", ...] = ()
    mesh: tuple[int, ...] = ()

    def opts(self) -> dict[str, Any]:
        return dict(self.options)

    def per_axis(self, rank: int) -> tuple["Candidate", ...]:
        """The axis-by-axis assignment this candidate denotes: its explicit
        ``axes``, or the same (backend, knobs) replicated across ``rank``."""
        if self.axes:
            if len(self.axes) != rank:
                raise ValueError(
                    f"candidate assigns {len(self.axes)} axes to a rank-"
                    f"{rank} problem: {self.key()}")
            return self.axes
        return (Candidate(self.backend, self.options),) * rank

    def key(self) -> str:
        if self.axes:
            return "nd[" + ";".join(a.key() for a in self.axes) + "]"
        base = self.backend
        if self.mesh:
            base += "[" + "x".join(str(s) for s in self.mesh) + "]"
        o = ",".join(f"{k}={v}" for k, v in self.options)
        return f"{base}({o})" if o else base

    @classmethod
    def from_key(cls, key: str) -> "Candidate":
        """Parse a plan key such as ``stockham_pallas(radix=4,tile_b=16)``,
        ``nd[dft;fourstep_pallas(tile_b=8)]`` or
        ``pencil[2x4](local=dft)``.  Integer knob values come back as
        ints."""
        key = key.strip()
        if key.startswith("nd[") and key.endswith("]"):
            axes = tuple(cls.from_key(k) for k in key[3:-1].split(";"))
            if any(a.mesh for a in axes):
                raise ValueError(f"a per-axis plan of single-device axes "
                                 f"only, got {key!r}")
            return cls("nd", axes=axes)
        m = _KEY.match(key)
        if m is None:
            raise ValueError(f"unsupported plan key {key!r} ('backend(k=v,"
                             "...)', 'backend[PxQ]' and 'nd[...]' keys only)")
        backend, mesh, body = m.groups()
        options = []
        for item in filter(None, (body or "").split(",")):
            k, sep, v = item.partition("=")
            if not sep or not k:
                raise ValueError(f"bad knob {item!r} in plan key {key!r}")
            options.append((k, int(v) if re.fullmatch(r"-?\d+", v) else v))
        return cls(backend, tuple(options),
                   mesh=tuple(int(s) for s in mesh.split("x")) if mesh else ())


def _pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def _smooth(n: int) -> bool:
    return n >= 1 and _factors_only(n, (2, 3, 5, 7, 11, 13))


def _smooth7(n: int) -> bool:
    return n >= 1 and _factors_only(n, (2, 3, 5, 7))


def _torch_dtype(precision: str):
    import torch
    return torch.complex64 if precision == "float" else torch.complex128


def stockham_max_n(precision: str) -> int:
    """Longest axis the Stockham kernel takes (2^20, the reference's)."""
    from ..kernels.stockham_pallas.ops import MAX_N
    return MAX_N[_torch_dtype(precision)]


def kernel_passes(backend: str, n: int, precision: str = "float") -> int:
    """Global-memory round trips of one axis of engine length ``n`` under a
    kernel backend: 1 where one block holds the signal, 2 where the kernel
    runs as passes (the Stockham kernel over its one-block cap, the
    four-step kernel where a signal's plane does not fit)."""
    if n == 1:
        return 1
    if backend == "stockham_pallas":
        from ..kernels.stockham_pallas.ops import ONE_BLOCK_N
        return 1 if n <= ONE_BLOCK_N[_torch_dtype(precision)] else 2
    if backend == "fourstep_pallas":
        from ..kernels.fft4step import ops as fs
        itemsize = 8 if precision == "float" else 16
        return 1 if fs.one_block(*fs.choose_factors(n), itemsize) else 2
    return 1


def fft2_passes(problem: Problem) -> int:
    """Global-memory round trips of the fused rank-2 kernel on the
    problem's engine tile: 1 where one block holds it, else the row pass's
    and the column pass's (each one or two: ``kernel_passes``; none for
    an extent of 1)."""
    from ..kernels.fft2_pallas.ops import ONE_BLOCK_ELEMS
    n1, n2 = problem.extents[0], axis_engine_n(problem, 1)
    if n1 * n2 <= ONE_BLOCK_ELEMS[_torch_dtype(problem.precision)]:
        return 1
    return sum(kernel_passes("stockham_pallas", n, problem.precision)
               for n in (n1, n2) if n > 1)


def axis_feasible(backend: str, n: int, precision: str = "float") -> bool:
    """Can ``backend`` transform one batched axis of engine length ``n``
    (see :func:`axis_engine_n`)?  The reference's rule, in both
    precisions.  Whole-transform backends other than ``xla`` have no
    per-axis form; the chirp backends take any length (odd real kinds run
    the full complex transform there)."""
    if backend in ("xla", "bluestein"):
        return True
    if backend == "stockham":
        return _pow2(n)
    if backend == "fourstep":
        return _smooth(n)
    if backend == "dft":
        from ..kernels.dft_matmul.dft_matmul import MAX_N
        return 1 <= n <= MAX_N
    if backend == "stockham_pallas":
        return _smooth7(n) and n <= stockham_max_n(precision)
    if backend == "fourstep_pallas":
        from ..kernels.fft4step.ops import feasible
        return feasible(n, _torch_dtype(precision))
    if backend == "chirpz_pallas":
        return 1 <= n <= CHIRPZ_PALLAS_MAX_N
    if backend == "sixstep":
        # the engine runs the Stockham kernel alone below SIXSTEP_MIN_N
        # (a packed real half can land there)
        return _pow2(n) and 2 <= n <= SIXSTEP_MAX_N
    return False


def axis_engine_n(problem: Problem, axis: int) -> int:
    """Extent the 1-D engine actually transforms along ``axis``: real kinds
    take the packed half-length path on the innermost axis (n//2 for even
    n; odd lengths pay the full complex transform)."""
    n = problem.extents[axis]
    if problem.complex_input or axis < problem.rank - 1:
        return n
    return n // 2 if n % 2 == 0 and n > 1 else n


def axis_elems(problem: Problem, axis: int) -> int:
    """Complex elements the transform carries while working on ``axis``:
    the whole signal for complex kinds; for real kinds the packed half on
    the innermost axis (even n) and the n_last//2 + 1 half-spectrum on
    every outer one."""
    if problem.complex_input:
        return problem.n_elems
    n_last = problem.extents[-1]
    rows = problem.n_elems // n_last
    if axis == problem.rank - 1:
        return rows * (n_last // 2) if n_last % 2 == 0 else problem.n_elems
    return rows * (n_last // 2 + 1)


def fft2_feasible(problem: Problem) -> bool:
    """The reference's rule for the fused rank-2 kernel: two power-of-two
    extents with n1*n2 <= 2^18 (an even last extent for a real kind, whose
    packed n1 x n2/2 tile the kernel transforms)."""
    from ..kernels.fft2_pallas.ops import MAX_ELEMS, pow2
    exts = problem.extents
    if len(exts) != 2 or not all(pow2(v) for v in exts):
        return False
    if not (problem.complex_input or exts[-1] % 2 == 0):
        return False
    return exts[0] * exts[1] <= MAX_ELEMS[_torch_dtype(problem.precision)]


def backend_supports(backend: str, problem: Problem) -> bool:
    """Can ``backend`` run ``problem`` (the reference's rules)?"""
    if backend == "fft2_pallas":
        return fft2_feasible(problem)
    if backend == "xla":
        return True
    if backend == "sixstep" and not all(
            _pow2(v) and SIXSTEP_MIN_N <= v <= SIXSTEP_MAX_N
            for v in problem.extents):
        return False   # offered only where six-step is the real algorithm
    return all(axis_feasible(backend, axis_engine_n(problem, i),
                             problem.precision)
               for i in range(problem.rank))


def _tile_fits(kernel: str, n: int, tile: int, itemsize: int,
               radix: int = 8) -> bool:
    """Does one block of the Stockham (``kernel`` "stockham_pallas") or
    four-step kernel hold ``tile`` rows of length ``n``?  A length-1 axis
    launches nothing; an axis the kernel runs as passes takes no tile."""
    from ..kernels.fft4step import fft4step as fs
    from ..kernels.stockham_pallas import stockham_pallas as sp
    from ..kernels.stockham_pallas.ops import SMEM_LIMIT_BYTES, smem_bytes

    if n == 1:
        return True
    if kernel == "stockham_pallas":
        need = smem_bytes(n, tile, itemsize, len(sp.radix_schedule(n, radix)))
    else:
        need = fs.smem_bytes(*fs.choose_factors(n), tile, itemsize)
    return need <= SMEM_LIMIT_BYTES


def _sixstep_fits(n: int, rows: int, tile_b: int, itemsize: int,
                  n1: int | None = None) -> bool:
    """Does a six-step transform of ``rows`` signals of length ``n`` take
    the batch tile in both its kernels?"""
    from ..fft import sixstep
    if n < SIXSTEP_MIN_N:
        return _tile_fits("stockham_pallas", n, min(tile_b, rows), itemsize)
    n1, n2 = sixstep.choose_split(n, n1)
    return (_tile_fits("stockham_pallas", n1, min(tile_b, rows * n2),
                       itemsize)
            and _tile_fits("fourstep_pallas", n2, min(tile_b, rows * n1),
                           itemsize))


def knobs_fit(problem: Problem, cand: Candidate) -> bool:
    """Does every launch of ``cand``'s kernels on ``problem`` fit one block
    with its ``tile_b`` (and ``radix``) knobs?  A tile is capped at the
    rows a launch has, as the wrappers cap it.  A chirp-Z knob is judged
    where its engine runs on the card (``bluestein.resolve_engine``)."""
    from ..fft.bluestein import resolve_engine
    from ..kernels.fft2_pallas import fft2_pallas as f2
    from ..kernels.stockham_pallas.ops import SMEM_LIMIT_BYTES

    opts = cand.opts()
    tile_b, radix = opts.get("tile_b"), opts.get("radix", 8)
    if tile_b is None:
        return True
    itemsize = 8 if problem.precision == "float" else 16
    if cand.backend == "fft2_pallas":
        n1, n2 = problem.extents[0], axis_engine_n(problem, 1)
        stages = sum(map(len, f2.schedules(n1, n2, radix)))
        tile = min(tile_b, problem.batch)
        return n1 * n2 == 1 or f2.smem_bytes(n1 * n2, tile, itemsize,
                                             stages) <= SMEM_LIMIT_BYTES
    for axis in range(problem.rank):
        n = axis_engine_n(problem, axis)
        rows = axis_elems(problem, axis) // n
        if cand.backend in ("stockham_pallas", "fourstep_pallas"):
            fits = _tile_fits(cand.backend, n, min(tile_b, rows), itemsize,
                              radix)
        elif cand.backend == "sixstep":
            fits = _sixstep_fits(n, rows, tile_b, itemsize,
                                 opts.get("split_n1"))
        elif cand.backend == "chirpz_pallas" and n > 1:
            engine, m = resolve_engine(n, opts.get("engine", "auto"))
            fits = (engine == "stockham"
                    or engine == "sixstep" and _sixstep_fits(
                        m, rows, tile_b, itemsize)
                    or engine == "stockham_pallas" and _tile_fits(
                        engine, m, min(tile_b, rows), itemsize))
        else:
            continue
        if not fits:
            return False
    return True


# ---------------------------------------------------------------------------
# distributed candidates: dist1d / slab / pencil over a mesh
# ---------------------------------------------------------------------------
def _mesh_devices(mesh) -> int:
    """Rank count of a mesh (or of a stand-in with ``.size``)."""
    return int(mesh.size)


def dist_supports(backend: str, problem: Problem,
                  mesh_shape: Sequence[int]) -> bool:
    """Can ``backend`` decompose ``problem`` over a mesh of
    ``mesh_shape``?  Complex kinds only (the packed real half-spectrum
    breaks the all_to_all divisibility), at least two ranks (one is pure
    overhead), and ``dist1d`` at batch 1 (its matrix view takes the whole
    axis)."""
    if not problem.complex_input:
        return False
    from ..fft import distributed as dist

    shape = tuple(int(s) for s in mesh_shape)
    p = 1
    for s in shape:
        p *= s
    if p < 2:
        return False
    if backend == "dist1d":
        return (problem.rank == 1 and problem.batch == 1
                and dist.can_shard_1d(problem.extents[0], p))
    if backend == "slab":
        return (len(shape) == 1 and problem.rank in (2, 3)
                and dist.slab_divisible(problem.extents, p))
    if backend == "pencil":
        return (len(shape) == 2 and problem.rank == 3
                and dist.pencil_divisible(problem.extents, *shape))
    return False


def _pencil_mesh_shapes(p: int, patient: bool = False
                        ) -> list[tuple[int, int]]:
    """(Pr, Pc) factorizations of ``p`` with both >= 2: the most balanced
    one, widened to at most four under PATIENT."""
    shapes = [(pr, p // pr) for pr in range(2, int(p ** 0.5) + 1)
              if p % pr == 0]
    shapes.sort(key=lambda s: s[1] - s[0])
    if not patient:
        return shapes[:1]
    out = list(shapes)
    out += [(pc, pr) for pr, pc in shapes if pr != pc]
    return out[:4]


def dist_local_lengths(problem: Problem, cand: Candidate
                       ) -> list[tuple[int, float]]:
    """The local transform lengths a distributed candidate runs on each
    rank, each with the transpose passes its position costs (2 where the
    axis is not innermost in the local block, 0 where it is)."""
    p = 1
    for s in cand.mesh:
        p *= s
    if cand.backend == "dist1d":
        from ..fft.distributed import _choose_1d_factors

        n1, n2 = _choose_1d_factors(problem.extents[0], p)
        return [(n1, 2.0), (n2, 0.0)]
    return [(n, 0.0 if i == problem.rank - 1 else 2.0)
            for i, n in enumerate(problem.extents)]


def _dist_candidates(problem: Problem, mesh, patient: bool
                     ) -> list[Candidate]:
    """The decompositions of ``problem`` over ``mesh``; PATIENT adds the
    other pencil factorizations and, for each decomposition, the two
    local engines with the fewest modeled passes besides the default (the
    ``local`` knob)."""
    from .costmodel import dist_local_engine, hbm_passes

    p = _mesh_devices(mesh)
    if p < 2:
        return []
    out: list[Candidate] = []
    if dist_supports("dist1d", problem, (p,)):
        out.append(Candidate("dist1d", mesh=(p,)))
    if dist_supports("slab", problem, (p,)):
        out.append(Candidate("slab", mesh=(p,)))
    for shape in _pencil_mesh_shapes(p, patient):
        if dist_supports("pencil", problem, shape):
            out.append(Candidate("pencil", mesh=shape))
    if patient:
        extra = []
        for c in out:
            lengths = [n for n, _ in dist_local_lengths(problem, c)]
            default = {dist_local_engine(n) for n in lengths}
            locals_ = [b for b in BACKENDS
                       if b not in FUSED_ND and b not in default
                       and all(axis_feasible(b, n) for n in lengths)
                       and all(hbm_passes(b, n) != float("inf")
                               for n in lengths)]
            locals_.sort(key=lambda b: sum(hbm_passes(b, n) for n in lengths))
            extra += [Candidate(c.backend, (("local", b),), mesh=c.mesh)
                      for b in locals_[:2]]
        out += extra
    return out


def candidates(problem: Problem, patient: bool = False,
               mesh=None) -> list[Candidate]:
    """Enumerate feasible (backend, knob) combinations for a problem: the
    vendor path, every homogeneous backend that supports the problem, the
    per-axis assignments for rank >= 2 (pruned by the bytes-moved model),
    the decompositions over ``mesh`` (``None``: the active mesh, itself
    None unless a launcher installed one), and under ``patient`` the
    kernels' knobs (batch tiles, radix schedules, the six-step split, the
    chirp-Z engine) -- those that fit a block at this problem's shape."""
    out: list[Candidate] = [Candidate("xla")]
    for b in BACKENDS[1:]:
        if backend_supports(b, problem):
            out.append(Candidate(b))
    if problem.rank >= 2:
        out += _mixed_candidates(problem, limit=12 if patient else 6)
    if mesh is None:
        from ..launch.mesh import get_active_mesh

        mesh = get_active_mesh()
    if mesh is not None:
        out += _dist_candidates(problem, mesh, patient)
    if patient:
        extra = []
        for c in out:
            if c.options or c.axes:
                continue
            if c.backend == "fourstep_pallas":
                for tb in (4, 8, 16):
                    extra.append(Candidate("fourstep_pallas", (("tile_b", tb),)))
            elif c.backend == "stockham_pallas":
                for tb in (4, 16):
                    for radix in (4, 8):
                        extra.append(Candidate(
                            "stockham_pallas",
                            (("radix", radix), ("tile_b", tb))))
            elif c.backend == "sixstep":
                for n1 in _sixstep_splits(problem.extents[-1]):
                    extra.append(Candidate("sixstep", (("split_n1", n1),)))
                extra.append(Candidate("sixstep", (("tile_b", 16),)))
            elif c.backend == "chirpz_pallas":
                # a forced engine applies to every axis, so each knob is
                # gated on every axis's engine length
                eng_ns = [axis_engine_n(problem, i)
                          for i in range(problem.rank)]
                if all(next_smooth(2 * v - 1) <= stockham_max_n(
                        problem.precision) for v in eng_ns):
                    extra.append(Candidate("chirpz_pallas",
                                           (("engine", "stockham_pallas"),)))
                if all(SIXSTEP_MIN_N <= _next_pow2(2 * v - 1) <= SIXSTEP_MAX_N
                       for v in eng_ns):
                    extra.append(Candidate("chirpz_pallas",
                                           (("engine", "sixstep"),)))
                extra.append(Candidate("chirpz_pallas", (("tile_b", 16),)))
            elif c.backend == "fft2_pallas":
                for tb in (2, 8):
                    for radix in (4, 8):
                        extra.append(Candidate(
                            "fft2_pallas",
                            (("radix", radix), ("tile_b", tb))))
        out += [c for c in extra if knobs_fit(problem, c)]
    return out


def _mixed_candidates(problem: Problem, limit: int) -> list[Candidate]:
    """Per-axis backend assignments, pruned by the bytes-moved model: each
    axis keeps its two separable backends with the fewest modeled passes at
    its engine length; the cross product, minus homogeneous assignments,
    is ranked by the full ND model and cut to ``limit``."""
    from .costmodel import estimate_bytes_moved, hbm_passes

    per_axis: list[list[str]] = []
    for i in range(problem.rank):
        n_eng = axis_engine_n(problem, i)
        feas = [b for b in BACKENDS
                if b not in FUSED_ND
                and axis_feasible(b, n_eng, problem.precision)]
        feas.sort(key=lambda b: hbm_passes(b, n_eng, problem.precision))
        per_axis.append(feas[:2])
    scored = []
    for combo in itertools.product(*per_axis):
        if len(set(combo)) == 1:
            continue  # homogeneous: already in the candidate list
        cand = Candidate("nd", axes=tuple(Candidate(b) for b in combo))
        cost = estimate_bytes_moved(problem, cand)
        if cost != float("inf"):
            scored.append((cost, cand))
    scored.sort(key=lambda t: t[0])
    return [cand for _, cand in scored[:limit]]


def _sixstep_splits(n: int) -> list[int]:
    """Alternative n = n1*n2 residual splits for the PATIENT sweep: the
    balanced split and a residual-heavy one, besides the default; both
    within ``sixstep.choose_split``'s limits (n1 <= 2^10, n2 <= 2^14), so
    every knob is one the engine honors."""
    if not _pow2(n) or n < SIXSTEP_MIN_N:
        return []
    k = n.bit_length() - 1
    default_k1 = k - min(14, k - 1)
    opts = {max(1, k // 2), max(1, min(10, k - 1))} - {default_k1}
    return sorted(1 << k1 for k1 in opts
                  if 1 <= k1 <= 10 and k - k1 <= 14)
