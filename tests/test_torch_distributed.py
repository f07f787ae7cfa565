"""The port's distributed transforms (``fft/distributed.py``,
``launch/mesh.py``) and clients (``core/clients/dist_fft.py``) against the
reference package's, on gloo ranks on the CPU.

* ``all_to_all`` against a one-process simulation of the tiled
  all_to_all (a list of per-rank blocks), at P = 2 and 4, for every
  (split, concat) pair the transforms use, over one axis and over tuples
  of axes of a (2, 2) mesh (the reversed tuple exercises the chunk
  permutation where the group's member order is not torch's);
* every builder on four gloo ranks, with ``dist_engines``' picks (``dft``
  up to 128 points, the four-step kernel's plain version at 256), against
  the reference's builders on four fake XLA devices, array for array in
  the same layout: the reference runs as ``tests/test_distributed_fft.py``
  runs it, in a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, from this file's
  ``__main__``; then each builder at P = 1 in process against the
  reference's on its one device;
* the two clients through ``Session.run`` on the CPU at P = 1 and on four
  ranks: Table-1 rows validated, the reference's failed nodes, and under
  MEASURE every rank holding the same pick with only rank 0 writing the
  wisdom file.

Bar: the suite's, rel-L2 1e-3 (complex64) and 1e-8 (complex128),
``tests/helpers/accuracy.py``.  Measured worst over the cases, four
ranks against four fake devices and P = 1 alike: 3.4e-7 (complex64),
5.9e-16 (complex128).
The ranks are spawned processes (``torch.multiprocessing``) that import
no JAX: the reference is imported only inside the functions that run it.
Each rank runs one torch thread and joins its group through a
``file://`` store under the test's temporary directory, never a fixed TCP
port, since the suite runs on several xdist workers at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers.accuracy import REL_L2_TOL, rel_l2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

N1D = 1024
#: (name, mesh shape, axis names, the axes the 1-D transform runs over)
MESHES_1D = (("flat", (4,), ("data",), "data"),
             ("2x2", (2, 2), ("d0", "d1"), ("d0", "d1")))
#: (name, global extents, batch): the conformance probes and one slab
#: problem whose local length 256 runs the four-step kernel's path
SLABS = (("16x16", (16, 16), 1), ("8x8x16", (8, 8, 16), 2),
         ("256x256", (256, 256), 1))
PENCIL = (8, 8, 16)
A2A_PAIRS = ((1, 0), (0, 1), (2, 1), (1, 2), (3, 2), (2, 3))
#: The all_to_all groups on four ranks: a (2, 2) mesh over each axis and
#: over both axes in either order.
A2A_AXES = ("d0", "d1", ("d0", "d1"), ("d1", "d0"))
SEED = 2017


def _cplx(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _inputs() -> dict:
    """The seeded inputs both packages transform."""
    rng = np.random.default_rng(SEED)
    out = {"x1d": _cplx(rng, N1D), "y1d": _cplx(rng, N1D),
           "x1d_c128": _cplx(rng, N1D, np.complex128)}
    for name, shape, batch in SLABS:
        out[f"x_{name}"] = _cplx(rng, (batch, *shape))
        out[f"y_{name}"] = _cplx(rng, (batch, *shape))
    out["x_pencil"] = _cplx(rng, (2, *PENCIL))
    out["y_pencil"] = _cplx(rng, (2, *PENCIL))
    out["x_3d"] = _cplx(rng, PENCIL)
    return out


def _case_names() -> list[str]:
    names = []
    for mesh, *_ in MESHES_1D:
        for layout in ("transposed", "natural"):
            names += [f"fft1d/{mesh}/{layout}", f"ifft1d/{mesh}/{layout}"]
    names += ["fft1d/c128", "ifft1d/c128_roundtrip"]
    for name, *_ in SLABS:
        for layout in ("transposed", "natural"):
            names += [f"slab/{name}/{layout}", f"islab/{name}/{layout}"]
    for layout in ("transposed", "natural"):
        names += [f"pencil/{layout}", f"ipencil/{layout}"]
    names += ["fft3d/canonical", "fft3d/keep_transposed", "ifft3d/canonical"]
    return names


CASES = _case_names()


# ---------------------------------------------------------------------------
# the reference, on fake XLA devices (this file's __main__, or in process)
# ---------------------------------------------------------------------------
def _reference_outputs(n_dev: int) -> dict:
    """Every case's global output from the reference's builders on a mesh
    of ``n_dev`` fake devices (1 or 4)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.fft import distributed as rdist
    from repro.launch.mesh import make_mesh

    def put(x, mesh, spec):
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))

    def mesh_of(shape, names):
        if n_dev == 1:
            shape = (1,) * len(shape)
        return make_mesh(shape, names)

    xs = _inputs()
    out = {}
    for mname, shape, names, axes in MESHES_1D:
        mesh = mesh_of(shape, names)
        spec = P(axes if isinstance(axes, str) else tuple(axes))
        for layout in ("transposed", "natural"):
            nat = layout == "natural"
            fn, _ = rdist.make_fft1d(mesh, axes, N1D, natural=nat)
            out[f"fft1d/{mname}/{layout}"] = np.asarray(
                fn(put(xs["x1d"], mesh, spec)))
            inv, _ = rdist.make_ifft1d(mesh, axes, N1D, natural=nat)
            out[f"ifft1d/{mname}/{layout}"] = np.asarray(
                inv(put(xs["y1d"], mesh, spec)))
    mesh = mesh_of((4,), ("data",))
    fn, _ = rdist.make_fft1d(mesh, "data", N1D)
    inv, _ = rdist.make_ifft1d(mesh, "data", N1D)
    y = fn(put(xs["x1d_c128"], mesh, P("data")))
    out["fft1d/c128"] = np.asarray(y)
    out["ifft1d/c128_roundtrip"] = np.asarray(inv(y))
    mesh = mesh_of((4,), ("data",))
    for name, shape, _ in SLABS:
        for layout in ("transposed", "natural"):
            nat = layout == "natural"
            fn, ins, outs = rdist.make_slab_fftnd(mesh, "data", shape,
                                                  natural=nat)
            out[f"slab/{name}/{layout}"] = np.asarray(
                fn(put(xs[f"x_{name}"], mesh, ins)))
            inv, ins, _ = rdist.make_slab_fftnd(mesh, "data", shape,
                                                natural=nat, inverse=True)
            out[f"islab/{name}/{layout}"] = np.asarray(
                inv(put(xs[f"y_{name}"], mesh, ins)))
    mesh = mesh_of((2, 2), ("d0", "d1"))
    for layout in ("transposed", "natural"):
        nat = layout == "natural"
        fn, ins, _ = rdist.make_pencil_fftnd(mesh, "d0", "d1", PENCIL,
                                             natural=nat)
        out[f"pencil/{layout}"] = np.asarray(
            fn(put(xs["x_pencil"], mesh, ins)))
        inv, ins, _ = rdist.make_pencil_fftnd(mesh, "d0", "d1", PENCIL,
                                              natural=nat, inverse=True)
        out[f"ipencil/{layout}"] = np.asarray(
            inv(put(xs["y_pencil"], mesh, ins)))
    spec3 = P("d0", "d1", None)
    x3 = put(xs["x_3d"], mesh, spec3)
    out["fft3d/canonical"] = np.asarray(
        rdist.make_fft3d(mesh, "d0", "d1", PENCIL)(x3))
    out["fft3d/keep_transposed"] = np.asarray(
        rdist.make_fft3d(mesh, "d0", "d1", PENCIL, keep_transposed=True)(x3))
    out["ifft3d/canonical"] = np.asarray(rdist.make_fft3d(
        mesh, "d0", "d1", PENCIL, inverse=True)(
            put(out["fft3d/canonical"], mesh, spec3)))
    return out


# ---------------------------------------------------------------------------
# the port, on the ranks of the default group
# ---------------------------------------------------------------------------
def _port_outputs() -> dict:
    """Every case's global output from the port's builders over the
    default group's ranks (4, or 1 with every mesh axis of size 1), with
    ``dist_engines``' local engines."""
    import torch.distributed as dist

    from repro_torch.core.candidates import Candidate
    from repro_torch.core.client import Problem
    from repro_torch.core.clients.dist_fft import dist_engines
    from repro_torch.fft import distributed as pdist
    from repro_torch.launch.mesh import make_mesh

    p = dist.get_world_size()

    def mesh_of(shape, names):
        return make_mesh(shape if p > 1 else (1,) * len(shape), names)

    def engines(extents, backend, mesh_shape, inverse, batch=1,
                precision="float"):
        problem = Problem(extents, "Outplace_Complex", precision, batch)
        cand = Candidate(backend, mesh=mesh_shape)
        return dist_engines(problem, cand, inverse, "cpu")[0]

    def run(fn, x, mesh, ins, outs):
        block = torch.from_numpy(np.ascontiguousarray(
            pdist.shard(x, mesh, ins)))
        return pdist.unshard(fn(block), mesh, outs).numpy()

    xs = _inputs()
    out = {}
    for mname, shape, names, axes in MESHES_1D:
        mesh = mesh_of(shape, names)
        spec = (axes if isinstance(axes, str) else tuple(axes),)
        for layout in ("transposed", "natural"):
            nat = layout == "natural"
            fn, _ = pdist.make_fft1d(
                mesh, axes, N1D, natural=nat,
                engines=engines((N1D,), "dist1d", (p,), False))
            out[f"fft1d/{mname}/{layout}"] = run(fn, xs["x1d"], mesh, spec,
                                                 spec)
            inv, _ = pdist.make_ifft1d(
                mesh, axes, N1D, natural=nat,
                engines=engines((N1D,), "dist1d", (p,), True))
            out[f"ifft1d/{mname}/{layout}"] = run(inv, xs["y1d"], mesh, spec,
                                                  spec)
    mesh = mesh_of((4,), ("data",))
    c128 = dict(dtype=torch.complex128, device="cpu")
    fn, _ = pdist.make_fft1d(mesh, "data", N1D, engines=engines(
        (N1D,), "dist1d", (p,), False, precision="double"), **c128)
    inv, _ = pdist.make_ifft1d(mesh, "data", N1D, engines=engines(
        (N1D,), "dist1d", (p,), True, precision="double"), **c128)
    block = torch.from_numpy(np.ascontiguousarray(
        pdist.shard(xs["x1d_c128"], mesh, ("data",))))
    y = fn(block)
    out["fft1d/c128"] = pdist.unshard(y, mesh, ("data",)).numpy()
    out["ifft1d/c128_roundtrip"] = pdist.unshard(inv(y), mesh,
                                                 ("data",)).numpy()
    for name, shape, batch in SLABS:
        for layout in ("transposed", "natural"):
            nat = layout == "natural"
            for inverse, key in ((False, "x"), (True, "y")):
                fn, ins, outs = pdist.make_slab_fftnd(
                    mesh, "data", shape, natural=nat, inverse=inverse,
                    engines=engines(shape, "slab", (p,), inverse, batch))
                out[f"{'i' if inverse else ''}slab/{name}/{layout}"] = run(
                    fn, xs[f"{key}_{name}"], mesh, ins, outs)
    mesh = mesh_of((2, 2), ("d0", "d1"))
    pshape = (2, 2) if p > 1 else (1, 1)
    for layout in ("transposed", "natural"):
        nat = layout == "natural"
        for inverse, key in ((False, "x"), (True, "y")):
            fn, ins, outs = pdist.make_pencil_fftnd(
                mesh, "d0", "d1", PENCIL, natural=nat, inverse=inverse,
                engines=engines(PENCIL, "pencil", pshape, inverse, 2))
            out[f"{'i' if inverse else ''}pencil/{layout}"] = run(
                fn, xs[f"{key}_pencil"], mesh, ins, outs)
    fn, ins, outs = pdist.make_fft3d(mesh, "d0", "d1", PENCIL)
    out["fft3d/canonical"] = run(fn, xs["x_3d"], mesh, ins, outs)
    fn, ins, outs = pdist.make_fft3d(mesh, "d0", "d1", PENCIL,
                                     keep_transposed=True)
    out["fft3d/keep_transposed"] = run(fn, xs["x_3d"], mesh, ins, outs)
    fn, ins, outs = pdist.make_fft3d(mesh, "d0", "d1", PENCIL, inverse=True)
    out["ifft3d/canonical"] = run(fn, out["fft3d/canonical"], mesh, ins,
                                  outs)
    return out


def _simulate_a2a(blocks: list, members: list, split: int,
                  concat: int) -> list:
    """The tiled all_to_all in one process: member i receives chunk i of
    every member's block along ``split``, concatenated along ``concat`` in
    member order."""
    p = len(members)
    out = {}
    for i, r in enumerate(members):
        parts = [np.split(blocks[s], p, axis=split)[i] for s in members]
        out[r] = np.concatenate(parts, axis=concat)
    return out


def _a2a_block(rank: int) -> np.ndarray:
    rng = np.random.default_rng(100 + rank)
    return _cplx(rng, (4, 8, 4, 8))


def _check_all_to_all() -> dict:
    """Every (group, split, concat) case against the simulation: the
    largest |difference| of this rank's block (the exchange copies, so it
    must be 0)."""
    import torch.distributed as dist

    from repro_torch.fft import distributed as pdist
    from repro_torch.launch.mesh import make_mesh

    p, rank = dist.get_world_size(), dist.get_rank()
    blocks = [_a2a_block(r) for r in range(p)]
    meshes = ({"flat": (make_mesh((p,), ("data",)), ("data",))} if p != 4
              else {"2x2": (make_mesh((2, 2), ("d0", "d1")), A2A_AXES)})
    out = {}
    for mname, (mesh, groups) in meshes.items():
        for axes in groups:
            for split, concat in A2A_PAIRS:
                got = pdist.all_to_all(torch.from_numpy(blocks[rank]), mesh,
                                       axes, split, concat).numpy()
                members = list(mesh.members(axes))
                want = _simulate_a2a(blocks, members, split, concat)[rank]
                label = "+".join((axes,) if isinstance(axes, str) else axes)
                out[f"P{p}/{mname}/{label}/{split}{concat}"] = (
                    float(np.abs(got - want).max())
                    if got.shape == want.shape else float("inf"))
    return out


#: The clients' Session.run nodes: (client, extents, kind, precision,
#: batch); the last three are the reference's failed nodes.
CLIENT_NODES = (
    ("TorchDistFFT1D", "1024", "Outplace_Complex", "float", 1),
    ("TorchDistFFT1D", "1024", "Inplace_Complex", "double", 1),
    ("TorchDistFFTND", "16x16", "Outplace_Complex", "float", 1),
    ("TorchDistFFTND", "8x8x16", "Inplace_Complex", "float", 2),
    ("TorchDistFFTND", "8x8x16", "Outplace_Complex", "double", 1),
    ("TorchDistFFT1D", "1024", "Outplace_Real", "float", 1),
    ("TorchDistFFT1D", "1024", "Outplace_Complex", "float", 4),
    ("TorchDistFFTND", "64", "Outplace_Complex", "float", 1),
)
#: The node each client's MEASURE run plans (slab[4] against
#: pencil[2x2] on four ranks).
MEASURE_NODE = ("TorchDistFFTND", "8x8x16", "Outplace_Complex", "float", 1)


def _run_node(node) -> list:
    """The node's validate rows, ``(success, error)``."""
    from repro_torch.core.client import TorchContext
    from repro_torch.core.suite import Session, SuiteSpec

    client, ext, kind, prec, batch = node
    rs = Session(TorchContext("cpu")).run(SuiteSpec(
        clients=(client,), extents=(ext,), kinds=(kind,), precisions=(prec,),
        batch=batch, warmups=1, repetitions=2, output=None))
    return [(r.success, r.error) for r in rs.rows if r.op == "validate"]


def _run_clients(tmp: str) -> dict:
    """Every client node through Session.run, then the MEASURE node with a
    wisdom path of this rank's own (so a file shows which rank wrote)."""
    import torch.distributed as dist

    from repro_torch.core.client import Problem, TorchContext
    from repro_torch.core.suite import Session, SuiteSpec
    from repro_torch.core.wisdom import Wisdom

    rank = dist.get_rank()
    out = {"validate": [_run_node(node) for node in CLIENT_NODES]}
    path = os.path.join(tmp, f"wisdom_rank{rank}.json")
    wisdom = Wisdom(path, device_kind="cpu")
    client, ext, kind, prec, batch = MEASURE_NODE
    rs = Session(TorchContext("cpu"), wisdom=wisdom).run(SuiteSpec(
        clients=(client,), extents=(ext,), kinds=(kind,), precisions=(prec,),
        rigor="measure", warmups=0, repetitions=1, output=None))
    pick = wisdom.lookup(Problem((8, 8, 16), kind, prec), scope="dist")
    out["measure"] = {"validate": [(r.success, r.error) for r in rs.rows
                                   if r.op == "validate"],
                      "pick": pick.key() if pick else None}
    return out


def _rank_main(rank: int, world: int, tmp: str) -> None:
    """One gloo rank: the all_to_all cases, then (on four ranks) the
    builders and the clients; each rank writes its results, then leaves
    without the interpreter's teardown (``exit_rank``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import exit_rank

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        results = {"a2a": _check_all_to_all()}
        if world == 4:
            outs = _port_outputs()
            if rank == 0:
                np.savez(os.path.join(tmp, "port.npz"),
                         **{k.replace("/", "|"): v for k, v in outs.items()})
            results["clients"] = _run_clients(tmp)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        dist.destroy_process_group()
    exit_rank()


def _spawn(world: int, tmp: str) -> list[dict]:
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(world, tmp), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _load_npz(path: str) -> dict:
    with np.load(path) as z:
        return {k.replace("|", "/"): z[k] for k in z.files}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The reference's outputs on four fake devices (a subprocess) and the
    port's four gloo ranks, run side by side."""
    tmp = str(tmp_path_factory.mktemp("dist4"))
    ref_path = os.path.join(tmp, "reference.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            ref_path], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        ranks = _spawn(4, tmp)
    finally:
        log, _ = ref.communicate(timeout=600)
    assert ref.returncode == 0, log
    return {"reference": _load_npz(ref_path),
            "port": _load_npz(os.path.join(tmp, "port.npz")),
            "ranks": ranks, "tmp": tmp}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _spawn(2, str(tmp_path_factory.mktemp("dist2")))


def _tol(name: str) -> float:
    return REL_L2_TOL["double" if "c128" in name else "float"]


@pytest.mark.parametrize("case", CASES)
def test_builders_on_four_ranks_are_the_references(four_ranks, case):
    got = four_ranks["port"][case]
    want = four_ranks["reference"][case]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_l2(got, want) <= _tol(case), rel_l2(got, want)


def test_complex128_roundtrip_on_four_ranks(four_ranks):
    x = _inputs()["x1d_c128"]
    got = four_ranks["port"]["ifft1d/c128_roundtrip"]
    assert rel_l2(got, x) <= REL_L2_TOL["double"]


def _a2a_cases(world: int) -> list[str]:
    p = world
    if p == 4:
        labels = ["+".join((a,) if isinstance(a, str) else a)
                  for a in A2A_AXES]
        return [f"P4/2x2/{g}/{s}{c}" for g in labels for s, c in A2A_PAIRS]
    return [f"P2/flat/data/{s}{c}" for s, c in A2A_PAIRS]


@pytest.mark.parametrize("case", _a2a_cases(4))
def test_all_to_all_on_four_ranks_is_the_simulation(four_ranks, case):
    assert all(r["a2a"][case] == 0.0 for r in four_ranks["ranks"])


@pytest.mark.parametrize("case", _a2a_cases(2))
def test_all_to_all_on_two_ranks_is_the_simulation(two_ranks, case):
    assert all(r["a2a"][case] == 0.0 for r in two_ranks)


@pytest.mark.parametrize("i", range(len(CLIENT_NODES)))
def test_clients_on_four_ranks(four_ranks, i):
    """Every rank validates the supported nodes and fails the others with
    the reference's message."""
    rows = [r["clients"]["validate"][i] for r in four_ranks["ranks"]]
    want = _reference_verdict(CLIENT_NODES[i])
    for got in rows:
        assert len(got) == 1
        (ok, err), = got
        assert ok == (want is None), err
        if want is not None:
            assert err.endswith(want)


def test_measure_agrees_across_ranks(four_ranks):
    picks = [r["clients"]["measure"]["pick"] for r in four_ranks["ranks"]]
    assert picks[0] in ("slab[4]", "pencil[2x2]")
    assert picks == [picks[0]] * 4
    for r in four_ranks["ranks"]:
        assert r["clients"]["measure"]["validate"] == [[True, ""]]
    written = sorted(f for f in os.listdir(four_ranks["tmp"])
                     if f.startswith("wisdom_rank"))
    assert written == ["wisdom_rank0.json"]
    with open(os.path.join(four_ranks["tmp"], written[0])) as f:
        (rec,) = json.load(f).values()
    assert rec["backend"] == picks[0].split("[")[0]
    assert rec["mesh"] == ([4] if picks[0] == "slab[4]" else [2, 2])


# ---------------------------------------------------------------------------
# P = 1, in process
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def one_rank():
    """The port's outputs at P = 1 (the one-rank gloo group a CPU client
    starts) and the reference's on its one device."""
    from repro_torch.launch.mesh import flat_mesh

    flat_mesh(device="cpu")            # the default group, if none yet
    import torch.distributed as dist
    if dist.get_world_size() != 1:
        pytest.fail("the test process's default group has more than one "
                    "rank")
    return {"port": _port_outputs(), "reference": _reference_outputs(1)}


@pytest.mark.parametrize("case", CASES)
def test_builders_at_one_rank_are_the_references(one_rank, case):
    got, want = one_rank["port"][case], one_rank["reference"][case]
    assert got.shape == want.shape
    assert rel_l2(got, want) <= _tol(case), rel_l2(got, want)


def _reference_verdict(node) -> str | None:
    """The reference client's constructor message for ``node``, or None
    where it takes the node."""
    from repro.core.client import Context, Problem as RProblem
    from repro.core.clients.dist_fft import DistFFT1DClient, DistFFTNDClient

    client, ext, kind, prec, batch = node
    cls = DistFFT1DClient if client == "TorchDistFFT1D" else DistFFTNDClient
    extents = tuple(int(v) for v in ext.split("x"))
    try:
        cls(RProblem(extents, kind, prec, batch), Context())
    except ValueError as e:
        return f"ValueError: {e}"
    return None


@pytest.mark.parametrize("i", range(len(CLIENT_NODES)))
def test_clients_at_one_rank(one_rank, i):
    rows = _run_node(CLIENT_NODES[i])
    want = _reference_verdict(CLIENT_NODES[i])
    assert len(rows) == 1
    (ok, err), = rows
    assert ok == (want is None), err
    if want is not None:
        assert err == want


def test_client_plan_at_one_rank_is_the_references(one_rank):
    """At P = 1 the ND client plans the reference's ``slab[1]`` at every
    rigor but WISDOM_ONLY, which is fftw's NULL plan."""
    from repro_torch.core.client import Problem, TorchContext
    from repro_torch.core.clients.dist_fft import TorchDistFFTND
    from repro_torch.core.plan import PlanCache, PlanRigor

    problem = Problem((8, 8, 16), "Outplace_Complex", "float")
    for rigor in (PlanRigor.ESTIMATE, PlanRigor.MEASURE, PlanRigor.PATIENT):
        client = TorchDistFFTND(problem, TorchContext("cpu"), rigor=rigor,
                                plan_cache=PlanCache())
        client.allocate()
        client.init_forward()
        assert client.plan.candidate.key() == "slab[1]"
        assert client.get_plan_size() > 0
    client = TorchDistFFTND(problem, TorchContext("cpu"),
                            rigor=PlanRigor.WISDOM_ONLY)
    with pytest.raises(RuntimeError, match="NULL plan"):
        client.allocate()


if __name__ == "__main__":
    # the reference on four fake XLA devices (XLA_FLAGS set by the caller)
    import jax

    jax.config.update("jax_enable_x64", True)
    outs = _reference_outputs(4)
    np.savez(sys.argv[1], **{k.replace("/", "|"): v for k, v in outs.items()})
