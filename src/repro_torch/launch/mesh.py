"""Rank meshes over ``torch.distributed``: the reference package's
``launch/mesh.py`` on process ranks instead of XLA devices.

A :class:`Mesh` is a rank layout (a numpy array of global ranks) with one
name per axis.  Building one touches no process group, so planning, which
reads only ``mesh.size``, works without one.  The communication group of
an axis, or of a tuple of axes, is built the first time a collective needs
it (:meth:`Mesh.group`).  That needs an initialized default group whose
world size is ``mesh.size``; every rank then creates every group of the
axis partition, in the same order (``new_subgroups_by_enumeration``),
since a rank that creates only its own group deadlocks the others.

A group's members are ordered row-major over the named axes, so a rank's
position in its group is the reference's ``_combined_index``.  torch
numbers a group's ranks in ascending global order; the collective helper
(``fft.distributed.all_to_all``) permutes its chunks where the two orders
differ.

When no default group exists, :func:`flat_mesh` starts a one-rank group on
the device's backend (``nccl`` for a CUDA device, ``gloo`` for the CPU)
through a ``FileStore`` in a temporary directory, so the transforms run
their collectives at P = 1 too.

The active mesh gates the planner's distributed candidates, as in the
reference: it is process-global state that a launcher installs
(:func:`set_active_mesh`, :class:`use_mesh`); discovering ranks never
activates one.
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
import weakref
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """Global ranks laid out on named axes (``ranks.shape`` is the mesh
    shape).  ``shape`` maps each axis name to its size, as a jax mesh's
    does."""

    def __init__(self, ranks, axis_names: Sequence[str]):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.ranks.shape} needs "
                             f"{self.ranks.ndim} axis names, got "
                             f"{self.axis_names}")
        if sorted(self.ranks.ravel().tolist()) != list(range(self.size)):
            raise ValueError(f"mesh ranks must be 0..{self.size - 1} once "
                             f"each, got {self.ranks.ravel().tolist()}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; the mesh has "
                             f"{self.axis_names}")
        return axes

    def partition(self, axes) -> tuple[tuple[int, ...], ...]:
        """Every group over ``axes``: the ranks that share every other
        coordinate, each ordered row-major over ``axes`` in the order
        given."""
        axes = self._axes(axes)
        named = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(self.ranks.ndim) if i not in named]
        grid = self.ranks.transpose(rest + named)
        width = math.prod(self.ranks.shape[i] for i in named)
        return tuple(tuple(int(r) for r in row)
                     for row in grid.reshape(-1, width))

    def members(self, axes, rank: int | None = None) -> tuple[int, ...]:
        """The group over ``axes`` that holds ``rank`` (default: this
        process's rank)."""
        rank = _this_rank() if rank is None else rank
        return next(g for g in self.partition(axes) if rank in g)

    def index(self, axes, rank: int | None = None) -> int:
        """``rank``'s position in its group over ``axes``: the reference's
        row-major combined axis index."""
        rank = _this_rank() if rank is None else rank
        return self.members(axes, rank).index(rank)

    def group(self, axes):
        """``(process group, members)`` of this rank's group over
        ``axes``; the groups are built on first use (every rank builds
        every group of the partition) and shared by every mesh over the
        same default group."""
        if not dist.is_initialized():
            raise RuntimeError("a collective over the mesh needs an "
                               "initialized default process group")
        world = dist.get_world_size()
        if world != self.size:
            raise RuntimeError(f"mesh of {self.size} ranks over a default "
                               f"group of {world}")
        part = self.partition(axes)
        return _process_group(part), self.members(axes)

    def device_mesh(self, device=None):
        """The ``torch.distributed`` DeviceMesh over the same ranks and
        axis names, on ``device``'s backend (``cuda`` for a CUDA device,
        else ``cpu``, which also carries ``meta`` tensors).  It is built
        once per default group and cached on the mesh; building it creates
        every axis's groups on every rank, in the same order."""
        from torch.distributed.device_mesh import DeviceMesh

        if not dist.is_initialized():
            raise RuntimeError("a device mesh needs an initialized default "
                               "process group")
        world = dist.get_world_size()
        if world != self.size:
            raise RuntimeError(f"mesh of {self.size} ranks over a default "
                               f"group of {world}")
        kind = "cuda" if torch.device(
            "cuda" if device is None else device).type == "cuda" else "cpu"
        cache = self.__dict__.setdefault("_device_meshes", {})
        held = cache.get(kind)
        if held is None or held[0]() is not dist.group.WORLD:
            dm = DeviceMesh(kind, torch.as_tensor(self.ranks),
                            mesh_dim_names=self.axis_names)
            held = cache[kind] = (weakref.ref(dist.group.WORLD), dm)
        return held[1]


#: Process groups by partition, for the default group (held weakly) they
#: were built in.
_GROUPS: dict = {"world": lambda: None, "groups": {}}


def _process_group(partition: tuple[tuple[int, ...], ...]):
    world = dist.group.WORLD
    if _GROUPS["world"]() is not world:
        _GROUPS["world"], _GROUPS["groups"] = weakref.ref(world), {}
    key = tuple(tuple(sorted(g)) for g in partition)
    if key == (tuple(range(dist.get_world_size())),):
        return None     # the default group itself
    if key not in _GROUPS["groups"]:
        mine, _ = dist.new_subgroups_by_enumeration([list(g) for g in key])
        _GROUPS["groups"][key] = mine
    return _GROUPS["groups"][key]


def _this_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device) -> torch.device:
    """The device of this rank's blocks: the CPU where ``device`` is the
    CPU, else ``cuda:<local rank>`` (``LOCAL_RANK``, or the rank modulo the
    visible cards)."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dist.is_initialized() and dist.get_world_size() > 1:
        return torch.device("cuda",
                            dist.get_rank() % torch.cuda.device_count())
    return torch.device("cuda", 0 if device.index is None else device.index)


def default_rank_device(device=None) -> torch.device:
    """``device`` where given, else this rank's card (:func:`rank_device`
    of ``"cuda"``); raises on a host without a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU found for this rank's blocks (pass "
                           "device='cpu' to run on the CPU)")
    return rank_device("cuda")


def ensure_default_group(device) -> None:
    """Start a one-rank default group on ``device``'s backend (``nccl``
    for a CUDA device, ``gloo`` for the CPU) where none exists, through a
    ``FileStore`` in a temporary directory."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    store = dist.FileStore(path, 1)
    if device.type == "cuda":
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=rank_device(device))
    else:
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)


def exit_rank(code: int = 0) -> None:
    """End a rank's process once its work is written and its group
    destroyed, without the interpreter's teardown: a gloo rank's process
    can abort there ("terminate called without an active exception", a
    C++ thread still joinable at exit) after all of its work succeeded."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layout (16x16, or 2x16x16 with
    ``pod``) as ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape, axes) -> Mesh:
    """Ranks 0..N-1 laid out row-major on ``shape``."""
    shape = tuple(int(s) for s in shape)
    return Mesh(np.arange(math.prod(shape)).reshape(shape), tuple(axes))


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


_ACTIVE_MESH = None


def set_active_mesh(mesh) -> None:
    """Install ``mesh`` (or ``None`` to clear) as the planning mesh."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_active_mesh():
    """The mesh distributed candidates plan against, or ``None``."""
    return _ACTIVE_MESH


class use_mesh:
    """Context manager: activate ``mesh`` for planning, restore on exit."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._prev = None

    def __enter__(self):
        self._prev = get_active_mesh()
        set_active_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_active_mesh(self._prev)
        return False


def flat_mesh(ranks=None, name: str = "data", device=None) -> Mesh:
    """A 1-D mesh over ``ranks`` (default: every rank of the default
    group, starting a one-rank group on ``device``, default ``cuda:0``,
    where none exists)."""
    if ranks is None:
        ensure_default_group("cuda:0" if device is None else device)
        ranks = range(dist.get_world_size())
    return Mesh(np.array(list(ranks)), (name,))


def reshaped_mesh(mesh: Mesh, shape, names=None) -> Mesh:
    """The same ranks as ``mesh`` viewed with ``shape`` (row-major), axes
    named ``d0``, ``d1``, ... by default."""
    shape = tuple(int(s) for s in shape)
    ranks = mesh.ranks.reshape(-1)
    if math.prod(shape) != ranks.size:
        raise ValueError(f"mesh of {ranks.size} devices cannot be viewed "
                         f"as shape {shape}")
    if names is None:
        names = tuple(f"d{i}" for i in range(len(shape)))
    return Mesh(ranks.reshape(shape), tuple(names))
