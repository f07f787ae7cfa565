"""The planner's distributed pieces on the port against the reference
package's: the cases of ``tests/test_dist_planner.py``, each also held
against the reference's function on the same input.

Candidate sets over a stand-in mesh (``FakeMesh``: enumeration reads only
``.size``) and ``_pencil_mesh_shapes``; ``dist_supports`` and
``dist_local_lengths``; ``estimate_bytes_moved`` on the goldens and the
dist1d crossover; ``dist_local_engine`` at 16-16384; wisdom's mesh
records, whose file text is equal; ``SuiteSpec.device_counts``, whose
dict, JSON and TOML text are the reference's; ``dist_support_matrix``,
whose rows are equal; the grid's ``--devices`` mode on gloo ranks
and the cost-model fitter skipping its mesh rows.
"""

import json
import math
import os
from types import SimpleNamespace

import pytest

from repro.core import candidates as rc
from repro.core import costmodel as rcm
from repro.core import suite as rsuite
from repro.core.client import Problem as RProblem
from repro.core.plan import Candidate as RCandidate
from repro.core.wisdom import Wisdom as RWisdom
from repro.fft import distributed as rdist
from repro_torch.core import candidates as pc
from repro_torch.core import costmodel as pcm
from repro_torch.core.client import Problem
from repro_torch.core.plan import (DIST_BACKENDS, Candidate,
                                   _pencil_mesh_shapes, candidates,
                                   dist_local_engine, dist_supports,
                                   estimate_bytes_moved)
from repro_torch.core.suite import SuiteSpec, dist_support_matrix
from repro_torch.core.wisdom import Wisdom
from repro_torch.fft import distributed as pdist
from repro_torch.launch.mesh import (dp_axes, get_active_mesh, make_mesh,
                                     make_production_mesh, reshaped_mesh,
                                     use_mesh)

from test_torch_tables import TITLES


class FakeMesh:
    """Enough mesh for the planner: enumeration reads only ``.size``."""

    def __init__(self, size: int):
        self.size = size


def _rp(p: Problem) -> RProblem:
    return RProblem(p.extents, p.kind, p.precision, p.batch)


def _keys(cands) -> list[str]:
    return [c.key() for c in cands]


PROBLEMS = (((4096,), "Outplace_Complex", 1), ((4096,), "Outplace_Complex", 4),
            ((1 << 16,), "Outplace_Complex", 1), ((64, 64), "Outplace_Complex", 1),
            ((16, 16, 16), "Outplace_Complex", 1),
            ((64, 64, 64), "Outplace_Complex", 1),
            ((48, 48, 48), "Inplace_Complex", 1),
            ((64, 64, 64), "Outplace_Real", 1), ((65, 64, 64), "Outplace_Complex", 1),
            ((438976,), "Outplace_Complex", 1), ((12, 12, 12), "Outplace_Complex", 2))


# --------------------------------------------------------------------------
# candidate enumeration
# --------------------------------------------------------------------------
def test_no_mesh_no_dist_candidates():
    assert get_active_mesh() is None
    for ext in ((4096,), (64, 64), (64, 64, 64)):
        backs = {c.backend for c in candidates(Problem(ext))}
        assert not backs & set(DIST_BACKENDS), ext


def test_single_device_mesh_adds_nothing():
    p = Problem((64, 64, 64), "Outplace_Complex")
    backs = {c.backend for c in candidates(p, mesh=FakeMesh(1))}
    assert not backs & set(DIST_BACKENDS)
    assert pc._dist_candidates(p, FakeMesh(1), False) == []


@pytest.mark.parametrize("size", [2, 4, 8, 16])
@pytest.mark.parametrize("patient", [False, True])
@pytest.mark.parametrize("i", range(len(PROBLEMS)))
def test_dist_candidates_are_the_references(i, patient, size):
    ext, kind, batch = PROBLEMS[i]
    p = Problem(ext, kind, batch=batch)
    mine = pc._dist_candidates(p, FakeMesh(size), patient)
    ref = rc._dist_candidates(_rp(p), FakeMesh(size), patient)
    assert _keys(mine) == _keys(ref)


def test_mesh_enumerates_sharded_decompositions():
    mesh = FakeMesh(8)
    keys = set(_keys(candidates(Problem((64, 64, 64), "Outplace_Complex"),
                                mesh=mesh)))
    assert {"slab[8]", "pencil[2x4]"} <= keys
    keys1 = set(_keys(candidates(Problem((4096,), "Outplace_Complex"),
                                 mesh=mesh)))
    assert "dist1d[8]" in keys1
    keys2 = set(_keys(candidates(Problem((64, 64), "Outplace_Complex"),
                                 mesh=mesh)))
    assert "slab[8]" in keys2
    assert not any(k.startswith("pencil") for k in keys2)


def test_active_mesh_gates_the_candidates():
    p = Problem((64, 64, 64), "Outplace_Complex")
    with use_mesh(FakeMesh(8)) as mesh:
        assert get_active_mesh() is mesh
        keys = _keys(candidates(p))
    assert get_active_mesh() is None
    assert keys[-len(pc._dist_candidates(p, mesh, False)):] == \
        _keys(pc._dist_candidates(p, mesh, False))
    assert {"slab[8]", "pencil[2x4]"} <= set(keys)


def test_patient_sweeps_decomposition_and_local_engine():
    cands = candidates(Problem((64, 64, 64), "Outplace_Complex"),
                       patient=True, mesh=FakeMesh(8))
    keys = set(_keys(cands))
    assert len(keys) == len(cands)
    assert {"pencil[2x4]", "pencil[4x2]"} <= keys
    locals_ = {c.opts().get("local") for c in cands
               if c.backend in DIST_BACKENDS and c.options}
    assert locals_ and all(locals_)


@pytest.mark.parametrize("p", [1, 2, 4, 6, 8, 12, 16, 36, 64])
@pytest.mark.parametrize("patient", [False, True])
def test_pencil_mesh_shapes(p, patient):
    assert _pencil_mesh_shapes(p, patient) == \
        rc._pencil_mesh_shapes(p, patient)
    assert _pencil_mesh_shapes(8) == [(2, 4)]
    assert _pencil_mesh_shapes(2) == []


def test_candidate_keys_read_mesh_shapes():
    for key in ("slab[4]", "pencil[2x4]", "dist1d[8]",
                "pencil[2x4](local=stockham_pallas)", "slab[1]"):
        cand = Candidate.from_key(key)
        assert cand.key() == key
    assert Candidate.from_key("pencil[2x4](local=dft)") == \
        Candidate("pencil", (("local", "dft"),), mesh=(2, 4))


# --------------------------------------------------------------------------
# dist_supports, dist_local_lengths
# --------------------------------------------------------------------------
MESH_SHAPES = ((1,), (2,), (4,), (8,), (2, 4), (4, 2), (2, 2), (1, 1))


@pytest.mark.parametrize("backend", ["dist1d", "slab", "pencil", "xla"])
@pytest.mark.parametrize("i", range(len(PROBLEMS)))
def test_dist_supports_is_the_references(i, backend):
    ext, kind, batch = PROBLEMS[i]
    p = Problem(ext, kind, batch=batch)
    for shape in MESH_SHAPES:
        assert dist_supports(backend, p, shape) == \
            rc.dist_supports(backend, _rp(p), shape), shape


def test_dist_supports_gating():
    p3 = Problem((64, 64, 64), "Outplace_Complex")
    assert dist_supports("slab", p3, (8,))
    assert dist_supports("pencil", p3, (2, 4))
    assert not dist_supports("slab", Problem((64, 64, 64), "Outplace_Real"),
                             (8,))
    assert not dist_supports("slab", p3, (1,))
    assert not dist_supports(
        "slab", Problem((65, 64, 64), "Outplace_Complex"), (8,))
    assert not dist_supports(
        "pencil", Problem((64, 63, 64), "Outplace_Complex"), (2, 4))
    assert dist_supports("dist1d", Problem((4096,), "Outplace_Complex"),
                         (8,))
    assert not dist_supports(
        "dist1d", Problem((4096,), "Outplace_Complex", batch=4), (8,))
    assert not dist_supports("dist1d", p3, (8,))
    assert not dist_supports("pencil", p3, (8,))
    assert not dist_supports("slab", p3, (2, 4))


@pytest.mark.parametrize("cand", ["dist1d[1]", "dist1d[4]", "dist1d[8]",
                                  "slab[4]", "pencil[2x4]"])
def test_dist_local_lengths_are_the_references(cand):
    for ext in ((4096,), (1 << 16,), (438976,)) \
            if cand.startswith("dist1d") else ((64, 64, 64), (512, 512, 256)):
        p = Problem(ext, "Outplace_Complex")
        assert pc.dist_local_lengths(p, Candidate.from_key(cand)) == \
            rc.dist_local_lengths(_rp(p), RCandidate(
                cand.split("[")[0],
                mesh=Candidate.from_key(cand).mesh))


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
def test_choose_1d_factors_is_the_references(p):
    for n in (1, 2, 12, 64, 100, 304, 1000, 1024, 4096, 19 ** 3, 438976,
              1 << 20):
        try:
            want = rdist._choose_1d_factors(n, p)
        except ValueError:
            with pytest.raises(ValueError):
                pdist._choose_1d_factors(n, p)
            continue
        assert pdist._choose_1d_factors(n, p) == want
        assert pdist.can_shard_1d(n, p) and rdist.can_shard_1d(n, p)


def test_choose_1d_factors_at_the_chip_size():
    """2^26 at one rank splits 8192 x 8192 (the chip's D1)."""
    assert pdist._choose_1d_factors(1 << 26, 1) == (8192, 8192)


# --------------------------------------------------------------------------
# the interconnect-aware cost model: goldens and crossover
# --------------------------------------------------------------------------
GOLDEN = {
    ((16, 16, 16), "xla"): 131072.0,
    ((16, 16, 16), "slab[8]"): 1122304.0,
    ((16, 16, 16), "pencil[2x4]"): 2187264.0,
    ((64, 64, 64), "xla"): 8388608.0,
    ((64, 64, 64), "slab[8]"): 5767168.0,
    ((64, 64, 64), "pencil[2x4]"): 7864320.0,
}


@pytest.mark.parametrize("ext,key", list(GOLDEN))
def test_interconnect_cost_goldens(ext, key):
    p = Problem(ext, "Outplace_Complex")
    cand = Candidate.from_key(key)
    mine = estimate_bytes_moved(p, cand)
    assert mine == GOLDEN[(ext, key)]
    assert mine == rcm.estimate_bytes_moved(
        _rp(p), RCandidate(cand.backend, mesh=cand.mesh))


@pytest.mark.parametrize("key", ["dist1d[2]", "dist1d[8]", "slab[2]",
                                 "slab[8]", "pencil[2x4]", "pencil[4x2]",
                                 "slab[8](local=stockham_pallas)",
                                 "pencil[2x4](local=fourstep)",
                                 "slab[4](natural=1)", "dist1d[8](natural=1)",
                                 "slab[8](local=sixstep)"])
@pytest.mark.parametrize("i", range(len(PROBLEMS)))
def test_estimates_are_the_references(i, key):
    ext, kind, batch = PROBLEMS[i]
    p = Problem(ext, kind, batch=batch)
    cand = Candidate.from_key(key)
    ref = RCandidate(cand.backend, cand.options, mesh=cand.mesh)
    assert estimate_bytes_moved(p, cand) == \
        rcm.estimate_bytes_moved(_rp(p), ref)


def test_dist1d_crossover():
    small = Problem((4096,), "Outplace_Complex")
    best_single = min(estimate_bytes_moved(small, c)
                      for c in candidates(small))
    assert best_single < estimate_bytes_moved(
        small, Candidate("dist1d", mesh=(8,)))
    big = Problem((1 << 22,), "Outplace_Complex")
    best_single = min(estimate_bytes_moved(big, c) for c in candidates(big))
    assert estimate_bytes_moved(big, Candidate("dist1d", mesh=(8,))) \
        < best_single


def test_planner_picks_dist_only_past_crossover():
    mesh = FakeMesh(8)

    def best(problem):
        return min(candidates(problem, mesh=mesh),
                   key=lambda c: estimate_bytes_moved(problem, c))

    assert best(Problem((16, 16, 16), "Outplace_Complex")).backend \
        not in DIST_BACKENDS
    assert best(Problem((64, 64, 64), "Outplace_Complex")).backend == "slab"


def test_infeasible_dist_candidate_costs_inf():
    p = Problem((64, 64, 64), "Outplace_Real")
    verdict = pcm.get_active_model().estimate(p, Candidate("slab",
                                                           mesh=(8,)))
    assert float(verdict) == float("inf") and "cannot decompose" in \
        verdict.reason


@pytest.mark.parametrize("n", [1 << k for k in range(4, 15)]
                         + [12, 48, 100, 945, 3072, 6859, 13824])
def test_dist_local_engine_is_the_references(n):
    want = rcm.dist_local_engine(n)
    assert dist_local_engine(n) == want
    if _is_pow2(n):
        assert want == ("dft" if n <= 128 else "fourstep_pallas")


def _is_pow2(n: int) -> bool:
    return n & (n - 1) == 0


def test_dist_local_engine_minimizes_passes():
    for n in (16, 64, 512, 4096):
        b = dist_local_engine(n)
        hp = pcm.get_active_model().hbm_passes
        assert hp(b, n) == min(hp(bb, n) for bb in
                               ("dft", "stockham", "fourstep",
                                "stockham_pallas", "xla"))


# --------------------------------------------------------------------------
# mesh-shaped wisdom records
# --------------------------------------------------------------------------
def test_wisdom_mesh_records_are_the_references(tmp_path):
    problem = Problem((64, 64, 64), "Outplace_Complex")
    recs = (Candidate("pencil", (("local", "stockham_pallas"),),
                      mesh=(2, 4)),
            Candidate("slab", mesh=(8,)))
    texts = []
    for pkg, (W, P, C) in {"port": (Wisdom, Problem, Candidate),
                           "ref": (RWisdom, RProblem, RCandidate)}.items():
        path = str(tmp_path / f"{pkg}.json")
        w = W(path, device_kind="testdev")
        p = P(problem.extents, problem.kind)
        w.record(p, C(recs[0].backend, recs[0].options, mesh=recs[0].mesh),
                 scope="dist")
        w.record(P((64, 64), "Outplace_Complex"),
                 C(recs[1].backend, mesh=recs[1].mesh), scope="dist")
        w.save()
        with open(path) as f:
            texts.append(f.read())
    assert texts[0] == texts[1]
    rec = json.loads(texts[0])
    assert sorted(r["mesh"] for r in rec.values()) == [[2, 4], [8]]
    got = Wisdom(str(tmp_path / "ref.json"), device_kind="testdev").lookup(
        problem, scope="dist")
    assert got == recs[0]
    assert got.key() == "pencil[2x4](local=stockham_pallas)"


def test_legacy_wisdom_records_still_load(tmp_path):
    wpath = str(tmp_path / "w.json")
    w = Wisdom(wpath, device_kind="testdev")
    problem = Problem((4096,), "Outplace_Complex")
    w.record(problem, Candidate("stockham_pallas", (("radix", 8),)))
    w.save()
    rec = next(iter(json.load(open(wpath)).values()))
    assert "mesh" not in rec
    got = Wisdom(wpath, device_kind="testdev").lookup(problem)
    assert got.mesh == () and got.key() == "stockham_pallas(radix=8)"


# --------------------------------------------------------------------------
# SuiteSpec device-count axis and the distributed support matrix
# --------------------------------------------------------------------------
def test_suitespec_device_counts_text_is_the_references():
    ref = rsuite.SuiteSpec(clients=("DistFFTND",), extents=("64x64x64",),
                           device_counts=(1, 2, 4, 8), output="d.csv")
    port = SuiteSpec(clients=("TorchDistFFTND",), extents=("64x64x64",),
                     device_counts=(1, 2, 4, 8), output="d.csv")
    d = port.to_dict()
    assert d["device_counts"] == [1, 2, 4, 8]
    want = ref.to_dict()
    want["clients"] = [TITLES[c] for c in want["clients"]]
    assert d == want
    mapped = ref.to_toml().replace('"DistFFTND"', '"TorchDistFFTND"')
    assert port.to_toml() == mapped
    assert port.to_json() == ref.to_json().replace('"DistFFTND"',
                                                   '"TorchDistFFTND"')
    assert SuiteSpec.from_toml(mapped) == port
    assert SuiteSpec.from_dict(json.loads(json.dumps(d))) == port
    assert SuiteSpec.from_toml(port.to_toml()).device_counts == (1, 2, 4, 8)


def test_suitespec_device_counts_validation_is_the_references():
    with pytest.raises(ValueError) as ref:
        rsuite.SuiteSpec(extents=("64",), device_counts=(0,), output=None)
    with pytest.raises(ValueError) as port:
        SuiteSpec(extents=("64",), device_counts=(0,), output=None)
    assert str(port.value) == str(ref.value)
    spec = SuiteSpec(clients=("TorchPlanned",), extents=("64",), output=None)
    assert "device_counts" not in spec.to_dict()
    assert SuiteSpec.from_dict(spec.to_dict()).device_counts == ()


@pytest.mark.parametrize("counts", [(2, 4, 8), (1, 3, 16)])
def test_dist_support_matrix_is_the_references(counts):
    assert dist_support_matrix(device_counts=counts) == \
        rsuite.dist_support_matrix(device_counts=counts)


def test_dist_support_matrix_shape_and_claims():
    rows = dist_support_matrix(device_counts=(2, 4, 8))
    by = {}
    for r in rows:
        if r["supported"]:
            by.setdefault(r["backend"], set()).add((r["rank"], r["devices"]))
    assert {(2, 2), (3, 2), (2, 4), (3, 4), (2, 8)} <= by["slab"]
    assert (3, 8) not in by["slab"]
    assert by["pencil"] == {(3, 4), (3, 8)}
    assert all(rank == 1 for rank, _ in by["dist1d"])
    assert not any(r["supported"] for r in rows if "Real" in r["kind"])


# --------------------------------------------------------------------------
# meshes (no process group needed)
# --------------------------------------------------------------------------
def test_mesh_layouts_are_the_references():
    from repro.launch import mesh as rmesh

    mesh = make_production_mesh()
    assert mesh.shape == {"data": 16, "model": 16}
    pod = make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("pod", "data", "model") and pod.size == 512
    for m in (mesh, pod):
        ref = SimpleNamespace(axis_names=m.axis_names)
        assert dp_axes(m) == rmesh.dp_axes(ref)
    assert dp_axes(pod) == ("pod", "data")
    view = reshaped_mesh(make_mesh((8,), ("data",)), (2, 4))
    assert view.axis_names == ("d0", "d1")
    assert view.ranks.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="cannot be viewed"):
        reshaped_mesh(view, (3, 3))


def test_mesh_groups_are_row_major_over_the_named_axes():
    mesh = make_mesh((2, 4), ("d0", "d1"))
    assert mesh.partition("d0") == ((0, 4), (1, 5), (2, 6), (3, 7))
    assert mesh.partition("d1") == ((0, 1, 2, 3), (4, 5, 6, 7))
    assert mesh.partition(("d1", "d0")) == ((0, 4, 1, 5, 2, 6, 3, 7),)
    # the reference's _combined_index: idx(d0) * |d1| + idx(d1)
    for r in range(8):
        assert mesh.index(("d0", "d1"), r) == r
        assert mesh.index(("d1", "d0"), r) == (r % 4) * 2 + r // 4


# --------------------------------------------------------------------------
# the grid's --devices mode on gloo ranks, and the fitter skipping it
# --------------------------------------------------------------------------
def test_bench_grid_devices_on_gloo_ranks(tmp_path):
    from repro_torch.benchmarks import bench_grid, fit_costmodel

    out = str(tmp_path / "dist.json")
    assert bench_grid.main(["--device", "cpu", "--devices", "1", "2",
                            "--smoke", "--out", out]) == 0
    with open(out) as f:
        doc = json.load(f)
    assert doc["meta"]["device_counts"] == [1, 2]
    assert [w["devices"] for w in doc["meta"]["workers"]] == [1, 2]
    rows = doc["results"]
    assert len(rows) == 2 * len(bench_grid.SMOKE_SCALING_EXTENTS) * 4
    for r in rows:
        ext = tuple(int(v) for v in r["extent"].split("x"))
        n = r["devices"]
        if r["backend"] == "xla":
            assert r["ok"], r
            continue
        if r["backend"] == "pencil":
            shape = (1, 1) if n == 1 else (_pencil_mesh_shapes(n) or [None])[0]
        else:
            shape = (n,)
        supported = shape is not None and (
            (r["backend"] == "dist1d" and len(ext) == 1
             and pdist.can_shard_1d(ext[0], n))
            or (r["backend"] == "slab" and len(ext) in (2, 3)
                and pdist.slab_divisible(ext, n))
            or (r["backend"] == "pencil" and len(ext) == 3
                and pdist.pencil_divisible(ext, *shape)))
        assert r["ok"] == supported, r
        if r["ok"]:
            assert r["mesh"] == "x".join(map(str, shape))
            assert r["collective_calls"] == \
                {"dist1d": 2, "slab": 1, "pencil": 2}[r["backend"]]
            block = r["batch"] * math.prod(ext) * 8 // n   # complex64
            assert r["collective_bytes"] == r["collective_calls"] * block
    assert any(r["backend"] == "pencil" and r["ok"] and r["mesh"] == "1x1"
               for r in rows)
    obs, skipped = fit_costmodel.bench_observations([out])
    assert all(o.backend == "xla" for o in obs)
    assert skipped.get("multi-device row", 0) == len(
        [r for r in rows if r["devices"] != 1 and r["ok"]])
    assert sum(v for k, v in skipped.items() if "without coefficients"
               in k) == len([r for r in rows if r["devices"] == 1
                             and r["ok"] and r["backend"] != "xla"])
    with pytest.raises(ValueError, match="needs 3 cards"):
        bench_grid.main(["--devices", "3", "--out", out])


def test_titles_name_the_distributed_clients():
    assert TITLES["DistFFT1D"] == "TorchDistFFT1D"
    assert TITLES["DistFFTND"] == "TorchDistFFTND"
    from repro_torch.core.registry import get_client
    from repro_torch.core import cli  # noqa: F401  (fills the registry)
    assert get_client("TorchDistFFT1D").title == "TorchDistFFT1D"
    assert os.path.basename(get_client("TorchDistFFTND").__module__
                            .replace(".", "/")) == "dist_fft"
