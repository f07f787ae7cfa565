"""The port's harness and FFT clients against the reference package.

* a CPU ``Session.run`` over ``TorchFFT`` and ``TorchStockhamPallas``
  validates every node (ranks 1-3, 4 kinds, 2 precisions), and so does one
  over ``TorchFourStepPallas`` and ``TorchFft2Pallas`` (rank 2 only);
* the result schema is the reference's, column for column;
* the clients' forward output matches the reference's ``_forward_fn`` on
  the same input (the reference's ``stockham_pallas`` in Pallas interpret
  mode), within rel-L2 1e-5 in float and 1e-12 in double: the same
  algorithm and twiddles, only the summation order differs; the same for
  the four-step and fused rank-2 clients;
* a problem over a kernel's cap (the reference's), or of the wrong rank,
  is a failed node, never a result of another backend; the feasibility
  rules are the reference's, and the reference's ``backends`` table's
  nodes that need the kernels' passes validate;
* byte accounting, plan keys, the device rule and the import rule.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers.accuracy import rand_input, rel_l2
from repro.core import candidates as ref_candidates
from repro.core import extents as ref_extents
from repro.core.client import Context as RefContext
from repro.core.client import Problem as RefProblem
from repro.core.clients import jax_fft
from repro.core.results import columns_for as ref_columns_for
from repro_torch.core import extents
from repro_torch.core.benchmark import BenchmarkConfig, run_node
from repro_torch.core.candidates import (Candidate, axis_engine_n,
                                        axis_feasible, backend_supports,
                                        fft2_feasible)
from repro_torch.core.client import KINDS, Problem, TorchContext
from repro_torch.core.clients.torch_fft import (TorchFFT, TorchFft2Pallas,
                                                TorchFourStepPallas,
                                                TorchStockhamPallas,
                                                _forward_fn)
from repro_torch.core.plan import PlanRigor
from repro_torch.core.results import open_sink
from repro_torch.core.suite import Session, SuiteSpec
from repro_torch.core.timer import Timer, timed
from repro_torch.core.tree import BenchNode, build_tree, select
from repro_torch.kernels.fft2_pallas import ops as f2_ops
from repro_torch.kernels.fft4step import ops as fs_ops
from repro_torch.kernels.stockham_pallas import ops

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")
EXAMPLES = os.path.join(os.path.dirname(SRC), "examples")
TOL = {"float": 1e-5, "double": 1e-12}
CLIENTS = {"TorchFFT": ("xla", TorchFFT),
           "TorchStockhamPallas": ("stockham_pallas", TorchStockhamPallas)}


@pytest.fixture
def cpu():
    return TorchContext("cpu")


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("client", list(CLIENTS))
def test_session_validates_every_node(client, precision, cpu):
    spec = SuiteSpec(clients=(client,), extents=((16,), (8, 12), (4, 4, 8)),
                     kinds=KINDS, precisions=(precision,), warmups=1,
                     repetitions=2, output=None)
    launches = ops.LAUNCHES
    rs = Session(cpu).run(spec)
    val = rs.query(op="validate")
    assert len(val) == 3 * len(KINDS)
    assert all(r.success for r in val), [r.error for r in rs.failures()]
    assert not rs.failures()
    assert {r.device for r in rs.rows} == {"cpu"}
    assert ops.LAUNCHES == launches       # CPU tensors never launch
    agg = rs.aggregate("execute_forward")
    assert len(agg) == 3 * len(KINDS) and all(a[-1] == 2 for a in agg)


def test_result_schema_is_the_reference_schema(tmp_path, cpu):
    out = tmp_path / "r.csv"
    spec = SuiteSpec(clients=("TorchStockhamPallas",), extents=((8,),),
                     kinds=("Outplace_Complex",), warmups=0, repetitions=1,
                     output=str(out))
    rs = Session(cpu).run(spec)
    with open(out, newline="") as f:
        header = next(csv.reader(f))
    assert header == ref_columns_for(True) == rs.columns
    spec = SuiteSpec(clients=("TorchFFT",), extents=((8,),),
                     kinds=("Outplace_Real",), warmups=0, repetitions=1,
                     plan_cache=False, output=str(tmp_path / "r.jsonl"))
    rs = Session(cpu).run(spec)
    with open(tmp_path / "r.jsonl") as f:
        first = json.loads(f.readline())
    assert list(first) == ref_columns_for(False) == rs.columns


def _forward_via_client(cls, problem, x, context):
    client = cls(problem, context)
    client.allocate()
    client.init_forward()
    client.upload(x)
    client.execute_forward()
    spec = client._spec.numpy().copy()
    client.init_inverse()
    client.execute_inverse()
    back = client.download()
    client.destroy()
    return spec, back, client


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("client", list(CLIENTS))
def test_forward_matches_reference_forward_fn(client, kind, precision, cpu):
    backend, cls = CLIENTS[client]
    problem = Problem((8, 12), kind, precision, batch=2)
    x = rand_input(problem, seed=5)
    want = np.asarray(jax_fft._forward_fn(
        RefProblem((8, 12), kind, precision, 2),
        ref_candidates.Candidate(backend))(x))
    got, back, c = _forward_via_client(cls, problem, x, cpu)
    assert got.shape == want.shape
    assert rel_l2(got, want) <= TOL[precision]
    assert rel_l2(back, x) <= TOL[precision]
    # the plan holds the twiddles of each engine length and, for real
    # kinds, the pack table of the last axis (6 roots of 12), both directions
    if backend == "xla":
        assert c.get_plan_size() == 0
    else:
        dtype = torch.complex64 if precision == "float" else torch.complex128
        lengths = {8, 12} if problem.complex_input else {8, 6}
        per_direction = sum(ops.make_twiddles(n, 8, False, dtype, "cpu").nbytes
                            for n in lengths)
        if not problem.complex_input:
            per_direction += 6 * dtype.itemsize
        assert c.get_plan_size() == 2 * per_direction > 0


@pytest.mark.parametrize("extents", [(8, 12), (15,)])
@pytest.mark.parametrize("kind", ["Outplace_Real", "Inplace_Real"])
def test_real_execute_builds_no_table(kind, extents, cpu, monkeypatch):
    """The R2C pack tables are plan state: built in ``init_*``, never in
    ``execute_*``."""
    from repro_torch.fft import rfft as port_rfft

    problem = Problem(extents, kind, "double", batch=2)
    x = rand_input(problem, seed=3)
    client = TorchStockhamPallas(problem, cpu)
    client.allocate()
    client.init_forward()
    client.init_inverse()
    client.upload(x)

    def no_build(*args, **kwargs):
        raise AssertionError("a table was built inside execute")

    monkeypatch.setattr(port_rfft, "half_roots", no_build)
    monkeypatch.setattr(ops, "make_twiddles", no_build)
    client.execute_forward()
    client.execute_inverse()
    assert rel_l2(client.download(), x) <= TOL["double"]


@pytest.mark.parametrize("kind", KINDS)
def test_alloc_size_matches_reference(kind):
    ctx = RefContext()
    for precision in ("float", "double"):
        for ext in ((16,), (8, 12), (4, 4, 7), (15,)):
            port = TorchFFT(Problem(ext, kind, precision, 3), TorchContext("cpu"))
            ref = jax_fft.XlaFFTClient(RefProblem(ext, kind, precision, 3), ctx)
            assert port.get_alloc_size() == ref.get_alloc_size()
            assert port.get_transfer_size() == ref.get_transfer_size()


class _FakeMesh:
    """Enough mesh for the planner's enumeration: ``.size``."""
    size = 8


def test_candidate_from_key_round_trips_reference_keys():
    keys = set()
    for ext, kind in (((4096,), "Outplace_Complex"), ((64, 48), "Outplace_Real"),
                      ((945,), "Inplace_Real"), ((256, 256, 256), "Outplace_Real"),
                      ((64, 64, 64), "Outplace_Complex")):
        for c in ref_candidates.candidates(RefProblem(ext, kind), patient=True,
                                           mesh=_FakeMesh()):
            keys.add((c.key(), c))
    all_keys = {k for k, _ in keys}
    assert "stockham_pallas(radix=4,tile_b=16)" in all_keys
    assert "nd[fourstep_pallas;stockham_pallas;dft]" in all_keys
    # the distributed slice's mesh keys read too
    assert {"dist1d[8]", "pencil[2x4]", "pencil[4x2]"} <= all_keys
    for key, ref in keys:
        cand = Candidate.from_key(key)
        assert cand.key() == key
        assert cand.backend == ref.backend and cand.opts() == ref.opts()
        assert cand.mesh == ref.mesh
        assert [(a.backend, a.opts()) for a in cand.axes] == \
            [(a.backend, a.opts()) for a in ref.axes]
    knobbed = Candidate.from_key("nd[dft;stockham_pallas(radix=4,tile_b=16)]")
    assert knobbed.per_axis(2)[1].opts() == {"radix": 4, "tile_b": 16}
    for bad in ("x(radix)", "nd[]", "nd[dft;slab[4]]", "slab[4x]"):
        with pytest.raises(ValueError):
            Candidate.from_key(bad)


def test_reference_plan_runs_the_same_schedule():
    """A plan the reference selected (radix and tile knobs) runs here and
    matches the reference's forward under that plan."""
    key = "stockham_pallas(radix=4,tile_b=16)"
    problem = Problem((4, 24), "Outplace_Complex", "double", 2)
    x = rand_input(problem, seed=9)
    want = np.asarray(jax_fft._forward_fn(
        RefProblem((4, 24), "Outplace_Complex", "double", 2),
        ref_candidates.Candidate("stockham_pallas",
                                 (("radix", 4), ("tile_b", 16))))(x))
    t = _forward_fn(problem, Candidate.from_key(key), "cpu")
    assert rel_l2(t(torch.from_numpy(x)), want) <= TOL["double"]


def test_hopper_cap_in_feasibility_and_as_a_failed_node(cpu):
    """The caps are the reference's in both precisions; one block's
    shared memory only decides whether a kernel runs as passes."""
    assert axis_feasible("stockham_pallas", 4096, "float")
    assert axis_feasible("stockham_pallas", 14406, "float")
    assert axis_feasible("stockham_pallas", 16384, "float")      # two passes
    assert axis_feasible("stockham_pallas", 8192, "double")      # two passes
    assert axis_feasible("stockham_pallas", 1 << 20, "double")
    assert not axis_feasible("stockham_pallas", 1 << 21, "float")
    assert not axis_feasible("stockham_pallas", 97, "float")
    assert axis_feasible("xla", 16384) and axis_feasible("xla", 97)
    # the fused rank-2 kernel has no per-axis form (as in the reference);
    # whole problems are held to the reference's 2^18 points, passes over
    # one block's 8192 (complex64) / 4096 (complex128)
    assert not axis_feasible("fft2_pallas", 64)
    assert fft2_feasible(Problem((64, 128), "Outplace_Complex", "float"))
    assert fft2_feasible(Problem((128, 128), "Outplace_Complex", "float"))
    assert fft2_feasible(Problem((512, 512), "Inplace_Complex", "double"))
    assert not fft2_feasible(Problem((1024, 512), "Outplace_Complex", "float"))
    assert not fft2_feasible(Problem((1024, 512), "Outplace_Real", "float"))
    assert not fft2_feasible(Problem((4, 4, 8), "Outplace_Complex"))
    assert axis_feasible("fourstep_pallas", 16384, "float")
    assert axis_feasible("fourstep_pallas", 16384, "double")     # two launches
    assert axis_feasible("fourstep_pallas", 13824, "double")     # two launches
    assert not axis_feasible("fourstep_pallas", 32768, "float")
    assert not axis_feasible("fourstep_pallas", 131, "float")
    # real kinds: the packed inner axis runs at n/2, an odd one at n
    real = Problem((16, 28812), "Outplace_Real", "float")
    assert [axis_engine_n(real, i) for i in (0, 1)] == [16, 14406]
    assert axis_engine_n(Problem((945,), "Inplace_Real"), 0) == 945
    big = Problem((1 << 21,), "Outplace_Complex", "float")
    spec = SuiteSpec(output=None, warmups=0, repetitions=1)
    rs = Session(cpu).run(spec, nodes=[BenchNode(TorchStockhamPallas, big)])
    (row,) = rs.failures()
    assert row.op == "validate" and "caps at n=1048576" in row.error


def test_non_estimate_rigor_is_a_failed_node(cpu):
    """MEASURE plans (and validates); WISDOM_ONLY with no wisdom is fftw's
    NULL plan: a failed node that ran no transform."""
    cpu.create()
    rows = []

    class Sink:
        def add(self, row):
            rows.append(row)

    node = BenchNode(TorchFFT, Problem((16,), "Outplace_Complex"))
    run_node(node, context=cpu, writer=Sink(),
             config=BenchmarkConfig(warmups=0, repetitions=1,
                                    rigor=PlanRigor.MEASURE))
    assert rows[-1].op == "validate" and rows[-1].success, rows[-1].error
    assert {r.rigor for r in rows} == {"measure"}
    rows.clear()
    run_node(node, context=cpu, writer=Sink(),
             config=BenchmarkConfig(warmups=0, repetitions=1,
                                    rigor=PlanRigor.WISDOM_ONLY))
    assert [r.op for r in rows] == ["validate"] and not rows[-1].success
    assert "NULL plan (wisdom miss)" in rows[-1].error


def test_plan_cache_reuses_builds(cpu):
    session = Session(cpu)
    spec = SuiteSpec(clients=("TorchStockhamPallas",), extents=((12,),),
                     kinds=("Outplace_Complex", "Outplace_Real"), warmups=1,
                     repetitions=2, output=None)
    first = session.run(spec)
    assert session.plan_cache.stats.misses == 4     # 2 problems x 2 directions
    misses = [r for r in first.rows if r.plan_cache == "miss"]
    assert misses and all(r.run == -1 for r in misses)
    second = session.run(spec)
    assert session.plan_cache.stats.misses == 4
    inits = [r for r in second.rows if r.op.startswith("init_")]
    assert inits and all(r.plan_cache == "hit" for r in inits)


def test_default_device_is_the_card():
    ctx = TorchContext()
    assert ctx.device == torch.device("cuda", 0)
    assert Session().context.device == torch.device("cuda", 0)
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="cuda:0"):
        ctx.create()
    with pytest.raises(RuntimeError, match="cuda:0"):
        Session().run(SuiteSpec(extents=((8,),), output=None))


def test_harness_copies_agree_with_reference():
    for spec in ("128x128x128", "1024", "3x5"):
        assert extents.parse_extents(spec) == ref_extents.parse_extents(spec)
    for ext in ((8, 16), (12, 7 * 5), (19,), (945,)):
        assert extents.classify(ext) == ref_extents.classify(ext)
    for v in (1, 11, 97, 1000, 2049):
        assert extents.next_smooth(v) == ref_extents.next_smooth(v)
    nodes = build_tree([TorchFFT, TorchStockhamPallas], [(8,), (4, 4)],
                       kinds=("Inplace_Real",), precisions=("float",))
    assert [n.path for n in select(nodes, "TorchStockhamPallas/*/4x4")] == \
        ["TorchStockhamPallas/float/4x4/Inplace_Real"]
    with pytest.raises(ValueError):
        open_sink("x.parquet", fmt="parquet")


def test_timer_waits_for_the_result():
    out, ms = timed(lambda: torch.ones(4) * 2)
    assert torch.equal(out, torch.full((4,), 2.0)) and ms >= 0.0
    with Timer() as t:
        pass
    assert t.time_ms >= 0.0


@pytest.mark.parametrize("shape,dtype", [
    ((1,), np.float32), ((7,), np.complex64), ((3, 5, 4), np.float64),
    (((1 << 20) * 2 + 3,), np.complex128)])
def test_roundtrip_error_is_the_reference(shape, dtype):
    """The chunked two-pass sample deviation equals the reference's
    whole-array formula (1e-12 relative), across a chunk boundary too;
    equal inputs give 0, and a constant offset what the reference gives
    (about 0 beyond one element, whose error is the offset itself)."""
    from repro.core.benchmark import roundtrip_error as ref_roundtrip
    from repro_torch.core.benchmark import roundtrip_error

    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(dtype)
    y = (x + 1e-6 * rng.standard_normal(shape)).astype(dtype)
    assert roundtrip_error(x, y) == pytest.approx(ref_roundtrip(x, y),
                                                  rel=1e-12)
    assert roundtrip_error(x, x) == 0.0
    offset = x + dtype(1e-3)
    assert roundtrip_error(x, offset) == pytest.approx(
        ref_roundtrip(x, offset), rel=1e-9, abs=1e-12)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"

        "need = ['repro_torch.core.cli', 'repro_torch.roofline.analysis']\n"
        "need += ['repro_torch.benchmarks.table_' + t for t in (\n"
        "    'overhead', 'tts', 'plan_rigor', 'backends', 'radix', 'dtypes',\n"
        "    'kernels')]\n"
        "need += ['repro_torch.benchmarks.' + t for t in (\n"
        "    'bench_grid', 'bench_diff', 'pregen_wisdom', 'fit_costmodel')]\n"
        "need += ['repro_torch.serve.' + m for m in (\n"
        "    'request', 'queue', 'coalescer', 'metrics', 'faults', 'engine',\n"
        "    'replay')]\n"
        "need += ['repro_torch.serve', 'repro_torch.core.clients.serve_fft',\n"
        "         'repro_torch.benchmarks.table_serve']\n"
        "need += ['repro_torch.launch.mesh', 'repro_torch.fft.distributed',\n"
        "         'repro_torch.core.clients.dist_fft']\n"
        "need += ['repro_torch.configs.base', 'repro_torch.data.pipeline',\n"
        "         'repro_torch.launch.serve']\n"
        "need += ['repro_torch.configs.' + c for c in (\n"
        "    'granite_moe_1b_a400m', 'deepseek_v2_lite_16b', 'gemma3_27b',\n"
        "    'starcoder2_7b', 'qwen3_1_7b', 'internlm2_20b',\n"
        "    'llama_3_2_vision_90b', 'xlstm_350m', 'hymba_1_5b',\n"
        "    'musicgen_medium')]\n"
        "need += ['repro_torch.models.' + m for m in (\n"
        "    'layers', 'attention', 'moe', 'ssm', 'model', 'convert',\n"
        "    'sharding')]\n"
        "need += ['repro_torch.launch.dryrun',\n"
        "         'repro_torch.roofline.op_count']\n"
        "need += ['repro_torch.train.' + m for m in (\n"
        "    'optimizer', 'compression', 'checkpoint', 'trainer')]\n"
        "need += ['repro_torch.launch.train',\n"
        "         'repro_torch.benchmarks.table_lm_steps',\n"
        "         'repro_torch.benchmarks.update_experiments']\n"
        "import glob, importlib.util, os\n"
        f"examples = sorted(glob.glob(os.path.join({EXAMPLES!r}, 'torch_*.py')))\n"
        "assert len(examples) == 5, examples\n"
        "for path in examples:\n"
        "    name = os.path.basename(path)[:-3]\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "from repro_torch.models.model import Model\n"
        "from repro_torch.models import convert\n"
        "assert callable(Model.loss_fn) and callable(convert.params_to_reference)\n"
        "from repro_torch.roofline import analysis\n"
        "assert callable(analysis.active_params) and callable(analysis.model_flops)\n"
        "from repro_torch.benchmarks import bench_grid\n"
        "assert callable(bench_grid._run_serve) and callable(bench_grid._run_chaos)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax')\n"
        "       or k == 'repro' or k.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert all(n in sys.modules for n in need), need\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


NEW_CLIENTS = {
    "TorchFourStepPallas": ("fourstep_pallas", TorchFourStepPallas, fs_ops),
    "TorchFft2Pallas": ("fft2_pallas", TorchFft2Pallas, f2_ops),
}
#: Extents each new client takes: four-step per axis at any rank, the
#: fused rank-2 kernel on power-of-two rank-2 tiles.
NEW_EXTENTS = {"TorchFourStepPallas": ((16,), (8, 12), (4, 4, 8), (945,)),
               "TorchFft2Pallas": ((8, 16), (16, 4), (1, 8), (8, 2))}


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("client", list(NEW_CLIENTS))
def test_new_clients_validate_every_node(client, precision, cpu):
    kernel_ops = NEW_CLIENTS[client][2]
    spec = SuiteSpec(clients=(client,), extents=NEW_EXTENTS[client],
                     kinds=KINDS, precisions=(precision,), warmups=1,
                     repetitions=2, output=None)
    launches = kernel_ops.LAUNCHES
    rs = Session(cpu).run(spec)
    val = rs.query(op="validate")
    assert len(val) == 4 * len(KINDS)
    assert all(r.success for r in val), [r.error for r in rs.failures()]
    assert {r.library for r in val} == {client}
    assert kernel_ops.LAUNCHES == launches      # CPU tensors never launch


def _plan_bytes(client, problem):
    """Both directions' tables of the client's plan, built here."""
    dtype = torch.complex64 if problem.precision == "float" \
        else torch.complex128
    n_last = axis_engine_n(problem, problem.rank - 1)
    total = 0
    for inverse in (False, True):
        if client == "TorchFft2Pallas":
            total += f2_ops.make_twiddles2(problem.extents[0], n_last, 8,
                                           inverse, dtype, "cpu").nbytes
        else:
            lengths = {axis_engine_n(problem, i) for i in range(problem.rank)}
            total += sum(fs_ops.make_tables(n, inverse, dtype, "cpu").nbytes
                         for n in lengths)
        if not problem.complex_input:
            total += problem.extents[-1] // 2 * dtype.itemsize
    return total


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("client", list(NEW_CLIENTS))
def test_new_client_forward_matches_reference_forward_fn(client, kind,
                                                         precision, cpu):
    backend, cls, _ = NEW_CLIENTS[client]
    extents = (8, 16) if client == "TorchFft2Pallas" else (8, 12)
    problem = Problem(extents, kind, precision, batch=2)
    x = rand_input(problem, seed=7)
    want = np.asarray(jax_fft._forward_fn(
        RefProblem(extents, kind, precision, 2),
        ref_candidates.Candidate(backend))(x))
    got, back, c = _forward_via_client(cls, problem, x, cpu)
    assert got.shape == want.shape
    assert rel_l2(got, want) <= TOL[precision]
    assert rel_l2(back, x) <= TOL[precision]
    assert c.get_plan_size() == _plan_bytes(client, problem) > 0


@pytest.mark.parametrize("kind", ["Outplace_Real", "Inplace_Complex"])
@pytest.mark.parametrize("client", list(NEW_CLIENTS))
def test_new_clients_execute_builds_no_table(client, kind, cpu, monkeypatch):
    """Twiddle, DFT and pack tables are plan state: built in ``init_*``,
    never in ``execute_*``."""
    from repro_torch.fft import rfft as port_rfft

    problem = Problem((8, 16), kind, "double", batch=2)
    x = rand_input(problem, seed=3)
    client_obj = NEW_CLIENTS[client][1](problem, cpu)
    client_obj.allocate()
    client_obj.init_forward()
    client_obj.init_inverse()
    client_obj.upload(x)

    def no_build(*args, **kwargs):
        raise AssertionError("a table was built inside execute")

    monkeypatch.setattr(port_rfft, "half_roots", no_build)
    monkeypatch.setattr(f2_ops, "make_twiddles2", no_build)
    monkeypatch.setattr(fs_ops, "make_tables", no_build)
    client_obj.execute_forward()
    client_obj.execute_inverse()
    assert rel_l2(client_obj.download(), x) <= TOL["double"]


def test_new_clients_fail_what_their_kernels_cannot_take(cpu):
    """Over a Hopper cap, a wrong rank or extent: a failed node whose error
    names the reason, never a result of another backend."""
    cases = [
        (TorchFft2Pallas, Problem((4, 4, 8), "Outplace_Complex"),
         "rank-2 only, got rank 3"),
        (TorchFft2Pallas, Problem((1024, 512), "Outplace_Complex", "float"),
         "caps at n1*n2=262144"),
        (TorchFft2Pallas, Problem((512, 1024), "Inplace_Complex", "double"),
         "caps at n1*n2=262144"),
        (TorchFft2Pallas, Problem((8, 12), "Outplace_Real"), "power-of-two"),
        (TorchFourStepPallas, Problem((32768,), "Outplace_Complex", "double"),
         "factorization"),
        (TorchFourStepPallas, Problem((8, 131), "Outplace_Complex"),
         "factorization"),
    ]
    spec = SuiteSpec(output=None, warmups=0, repetitions=1)
    rs = Session(cpu).run(spec, nodes=[BenchNode(cls, p) for cls, p, _ in cases])
    fails = rs.failures()
    assert len(fails) == len(cases) and len(rs.query(op="validate")) == len(cases)
    for row, (_, _, reason) in zip(fails, cases):
        assert row.op == "validate" and reason in row.error, row.error
        assert not rs.query(op="execute_forward", library=row.library,
                            extents=row.extents)


@pytest.mark.parametrize("n,precision", [(16384, "float"), (8192, "double"),
                                         (16384, "double")])
def test_fourstep_cap_agrees_with_reference(n, precision):
    """The four-step kernel takes the reference's longest lengths: n =
    16384 in both precisions (two launches in double) and 8192 are
    feasible in both packages (the reference's rule has no precision)."""
    assert axis_feasible("fourstep_pallas", n, precision)
    assert ref_candidates.axis_feasible("fourstep_pallas", n) \
        == axis_feasible("fourstep_pallas", n, precision)


def test_support_rules_match_reference_below_the_caps():
    """The port's support matrix is the reference's, below and at the
    caps, which now agree (Stockham 2^20, the four-step kernel 128x128,
    fft2 2^18 points) and over them."""
    exts = ((16,), (945,), (131,), (8, 12), (8, 16), (1, 8), (16, 1),
            (4, 4, 8), (64, 32), (7, 9), (13824,), (16384,), (65536,),
            (1 << 20,), (3 << 20,), (128, 128), (256, 256), (1024, 512))
    for ext in exts:
        for kind in KINDS:
            for precision in ("float", "double"):
                port = Problem(ext, kind, precision)
                ref = RefProblem(ext, kind, precision)
                for backend in ("xla", "stockham_pallas", "fourstep_pallas",
                                "fft2_pallas"):
                    assert backend_supports(backend, port) == \
                        ref_candidates.backend_supports(backend, ref), \
                        (backend, ext, kind, precision)


@pytest.mark.parametrize("precision", ["float", "double"])
def test_feasibility_is_the_reference_at_the_caps(precision):
    """axis_feasible and fft2_feasible against the reference's candidates
    at and over the caps: one block's shared memory no longer refuses
    anything the reference takes."""
    for n in (16384, 65536, 1 << 20, 3 << 20, 13824, 14406, 7203, 32768):
        for backend in ("stockham_pallas", "fourstep_pallas", "dft", "xla"):
            assert axis_feasible(backend, n, precision) == \
                ref_candidates.axis_feasible(backend, n), (backend, n)
    for ext in ((128, 128), (256, 256), (1024, 512), (512, 512), (1, 1 << 18)):
        for kind in KINDS:
            assert fft2_feasible(Problem(ext, kind, precision)) == \
                ref_candidates.fft2_feasible(RefProblem(ext, kind, precision)), \
                (ext, kind)


@pytest.mark.parametrize("client,extents", [
    (TorchStockhamPallas, (65536,)), (TorchFft2Pallas, (256, 256))])
def test_backends_table_nodes_validate(client, extents, cpu):
    """The reference's ``backends`` table (benchmarks/table_backends.py)
    runs 65536 Outplace_Real under StockhamPallas (packed n = 32768: two
    passes) and 256x256 under Fft2Pallas (packed 256x128: passes); both
    validate here, through the kernels' plain versions."""
    spec = SuiteSpec(output=None, warmups=0, repetitions=1)
    node = BenchNode(client, Problem(extents, "Outplace_Real", "float", 1))
    rs = Session(cpu).run(spec, nodes=[node])
    assert not rs.failures()
    (val,) = rs.query(op="validate")
    assert val.success


def test_build_cache_keys_on_shared_headers(tmp_path, monkeypatch):
    """An edited shared header (``csrc/*.cuh``) gives every library a new
    build target, so no stale library is reused; nothing is compiled."""
    from repro_torch.kernels import _build

    (tmp_path / "a.cu").write_text('#include "s.cuh"\n')
    (tmp_path / "b.cu").write_text("// no header\n")
    (tmp_path / "s.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.sources() == ["a", "b"]
    before = {n: _build._target(n) for n in ("a", "b")}
    assert before == {n: _build._target(n) for n in ("a", "b")}
    (tmp_path / "s.cuh").write_text("// v2\n")
    after = {n: _build._target(n) for n in ("a", "b")}
    assert all(after[n] != before[n] for n in ("a", "b"))
    assert {p.parent for p in after.values()} == {_build.BUILD_DIR}
