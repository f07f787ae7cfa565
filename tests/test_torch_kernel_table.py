"""The port's kernel table and the harness hooks under it, against the
reference package's.

* ``run_node`` with a client class that brings its own schedule,
  ``make_host_input`` and ``check`` writes the reference's rows (ops,
  bytes, validate row and its error) for the same toy client; the FFT
  clients' rows are the reference's;
* ``ResultSet.aggregate_named`` agrees with the reference's on the same
  rows;
* the port's table (``repro_torch.benchmarks.table_kernels``) runs every
  spec through ``Session.run`` on a CPU session with every node
  validated, and every client's download matches the reference client's
  output (its ``_call``, Pallas kernels in interpret mode) on the same
  host input;
* titles, row names and specs map one to one onto the reference's.

Tolerance for the downloads: rel-L2 <= 1e-5, tighter than the suite's
complex64 bar of 1e-3: each pair computes the same function in float32
from the same float64-built tables, and every port client's algorithm
(on the CPU, its kernel's plain version) is the reference client's, up
to the summation order.
"""

import os
import subprocess
import sys
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest

from helpers.accuracy import rel_l2

from repro.core import benchmark as rbench
from repro.core import registry as rregistry
from repro.core import schedule as rschedule
from repro.core.client import Context as RContext
from repro.core.client import Problem as RProblem
from repro.core.clients.jax_fft import XlaFFTClient
from repro.core.results import Row as RRow
from repro.core.suite import ResultSet as RResultSet
from repro.core.tree import BenchNode as RBenchNode
from repro_torch.benchmarks import run as port_run
from repro_torch.benchmarks import table_kernels as tk
from repro_torch.core import benchmark as pbench
from repro_torch.core import schedule as pschedule
from repro_torch.core.client import Problem, TorchContext
from repro_torch.core.clients.torch_fft import TorchFFT
from repro_torch.core.results import Row
from repro_torch.core.suite import ResultSet, Session
from repro_torch.core.tree import BenchNode
from repro_torch.kernels.fftconv import ops as conv_ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
if ROOT not in sys.path:     # the reference's benchmarks/ package
    sys.path.insert(0, ROOT)
from benchmarks import table_kernels as ref_tk  # noqa: E402

TOL = 1e-5
#: Row fields that must agree between the two packages (not the client
#: title, the device or the times).
SAME = ("extents", "rank", "extent_class", "precision", "kind", "rigor",
        "run", "op", "bytes", "success", "error", "plan_cache")


class _Sink:
    def __init__(self):
        self.rows = []

    def add(self, row):
        self.rows.append(row)


def _toy(sched_mod, mode: str):
    """A client with its own schedule, host input and check, written once
    per package (each package's OpSchedule)."""
    step = sched_mod.OpStep

    class Toy:
        title = f"Toy_{mode}"
        schedule = sched_mod.OpSchedule("toy", (
            step("allocate", "allocate"),
            step("upload", "upload", needs_input=True,
                 bytes_method="get_transfer_size"),
            step("execute_forward", "execute_forward"),
            step("download", "download", captures_output=True),
            step("destroy", "destroy"),
        ))

        def __init__(self, problem, context, rigor=None, wisdom=None,
                     plan_cache=None):
            self.problem = problem

        @classmethod
        def make_host_input(cls, problem, seed):
            return (np.arange(problem.extents[0], dtype=np.float32) + seed,)

        @classmethod
        def check(cls, problem, host_in, out, error_bound):
            ok = mode == "ok" and np.array_equal(out, 2 * host_in[0])
            return ok, "" if ok else "toy output wrong"

        def allocate(self):
            pass

        def upload(self, host):
            self.x = host[0]

        def get_transfer_size(self):
            return self.x.nbytes

        def execute_forward(self):
            if mode == "raise":
                raise ValueError("toy kernel refused the shape")
            self.y = 2 * self.x

        def download(self):
            return self.y

        def destroy(self):
            pass

    return Toy


def _rows_of_both(port_cls, ref_cls, kind="Outplace_Complex", extents=(8,),
                  precision="float"):
    cfg = dict(warmups=1, repetitions=2, seed=7)
    port = _Sink()
    context = TorchContext("cpu")
    context.create()
    pbench.run_node(BenchNode(port_cls, Problem(extents, kind, precision)),
                    context=context, config=pbench.BenchmarkConfig(**cfg),
                    writer=port)
    ref = _Sink()
    rcontext = RContext()
    rcontext.create()
    rbench.run_node(RBenchNode(ref_cls, RProblem(extents, kind, precision)),
                    context=rcontext, config=rbench.BenchmarkConfig(**cfg),
                    writer=ref)
    return port.rows, ref.rows


def _same(port_rows, ref_rows, plan_bytes=True):
    """The rows agree field for field (``plan_bytes=False``: but for the
    bytes of the planning ops)."""
    def key(r):
        return tuple(0 if f == "bytes" and not plan_bytes
                     and r.op.startswith("init_") else getattr(r, f)
                     for f in SAME)
    assert [key(r) for r in port_rows] == [key(r) for r in ref_rows]


@pytest.mark.parametrize("mode", ["ok", "bad", "raise"])
def test_run_node_takes_the_client_schedule_input_and_check(mode):
    """The toy client's own schedule (no planning or inverse ops), its own
    host input (seeded) and its own check: the reference's rows, op for
    op, and the same validate row (passed, failed with the check's
    message, or failed with the raise)."""
    port_rows, ref_rows = _rows_of_both(_toy(pschedule, mode),
                                        _toy(rschedule, mode))
    _same(port_rows, ref_rows)
    (val,) = [r for r in port_rows if r.op == "validate"]
    assert val.success == (mode == "ok")
    assert val.error == {"ok": "", "bad": "toy output wrong",
                         "raise": "ValueError: toy kernel refused the shape"
                         }[mode]
    if mode != "raise":
        ops = [r.op for r in port_rows if r.run == 0]
        assert ops == list(_toy(pschedule, mode).schedule.op_names)
        assert {r.bytes for r in port_rows if r.op == "upload"} == {32}


@pytest.mark.parametrize("kind", ["Outplace_Real", "Inplace_Complex"])
def test_fft_client_rows_are_unchanged(kind):
    """A client without the hooks still runs the Table-1 schedule on the
    see-saw input with the roundtrip check: TorchFFT's rows are XlaFFT's.
    Only the planning ops' bytes differ: the reference counts its compiled
    XLA executable, which torch.fft has no counterpart of (0)."""
    port_rows, ref_rows = _rows_of_both(TorchFFT, XlaFFTClient, kind, (8, 12))
    _same(port_rows, ref_rows, plan_bytes=False)
    assert {r.bytes for r in port_rows if r.op.startswith("init_")} == {0}
    assert [r.op for r in port_rows if r.run == 0] == \
        list(pschedule.FFT_SCHEDULE.op_names)
    assert port_rows[-1].op == "validate" and port_rows[-1].success


@pytest.mark.parametrize("op", [None, "execute_forward"])
def test_aggregate_named_matches_reference(op):
    rng = np.random.default_rng(3)
    fields = []
    for lib in ("A", "B"):
        for name in ("execute_forward", "upload"):
            for run in range(5):
                fields.append(dict(
                    library=lib, device="cpu", extents="64", rank=1,
                    extent_class="powerof2", precision="float",
                    kind="Outplace_Real", rigor="estimate", run=run, op=name,
                    time_ms=float(rng.random()), success=run != 3))
    port = ResultSet([Row(**f) for f in fields], [])
    ref = RResultSet([RRow(**f) for f in fields], [])
    mine = port.aggregate_named(op)
    theirs = ref.aggregate_named(op)
    assert len(mine) == len(theirs) > 0
    for a, b in zip(mine, theirs):
        assert a.as_tuple() == b.as_tuple()
        assert (a.library, a.op, a.mean, a.sd, a.n) == \
            (b.library, b.op, b.mean, b.sd, b.n)
    assert [a.as_tuple() for a in mine] == port.aggregate(op)


def _recording(cls):
    """``cls`` whose downloads are kept (the title is inherited)."""
    class Recording(cls):
        outputs = []

        def download(self):
            out = super().download()
            Recording.outputs.append(out)
            return out
    return Recording


def _ref_title(title: str) -> str:
    return title.replace("Cuda", "Interp").replace("Torch", "Jnp")


@pytest.mark.parametrize("index", range(len(tk.SPECS)))
def test_table_spec_validates_and_matches_reference_clients(index):
    """One spec of the port's table through Session.run on the CPU: every
    node validated; every client's host input is the reference client's,
    and its download matches the reference client's ``_call``."""
    spec = replace(tk.SPECS[index], warmups=0, repetitions=1)
    nodes = [BenchNode(_recording(n.client_cls), n.problem)
             for n in spec.build_nodes()]
    launches = conv_ops.LAUNCHES
    rs = Session(TorchContext("cpu")).run(spec, nodes=nodes)
    assert conv_ops.LAUNCHES == launches
    val = rs.query(op="validate")
    assert len(val) == len(spec.clients) and all(r.success for r in val), \
        [r.error for r in rs.failures()]
    for node in nodes:
        p = node.problem
        ref_cls = rregistry.get_client(_ref_title(node.client_cls.title))
        rp = RProblem(p.extents, p.kind, p.precision, p.batch)
        host = node.client_cls.make_host_input(p, spec.seed)
        ref_host = ref_cls.make_host_input(rp, spec.seed)
        for a, b in zip(host, ref_host, strict=True):
            np.testing.assert_array_equal(a, b)
        want = np.asarray(ref_cls(rp, None)._call(
            *(jnp.asarray(a) for a in ref_host)))
        (got,) = node.client_cls.outputs
        assert got.shape == want.shape and got.dtype == want.dtype
        assert rel_l2(got, want) <= TOL, node.client_cls.title


def test_titles_names_and_specs_map_onto_the_reference():
    """``Interp``/``_interp`` become ``Cuda``/``_cuda`` and ``Jnp``/``_jnp``
    become ``Torch``/``_torch``; everything else is the reference's."""
    swap = (("Interp", "Cuda"), ("Jnp", "Torch"), ("_interp", "_cuda"),
            ("_jnp", "_torch"))

    def port_name(s):
        for a, b in swap:
            s = s.replace(a, b)
        return s
    assert tk.NAMES == {port_name(t): port_name(r)
                        for t, r in ref_tk.NAMES.items()}
    assert len(set(tk.NAMES.values())) == len(tk.NAMES)
    assert len(tk.SPECS) == len(ref_tk.SPECS)
    for mine, theirs in zip(tk.SPECS, ref_tk.SPECS):
        assert mine.clients == tuple(port_name(c) for c in theirs.clients)
        for f in ("extents", "batch", "kinds", "precisions", "warmups",
                  "plan_cache", "output"):
            assert getattr(mine, f) == getattr(theirs, f), f
    assert (tk.FftconvFusedKernel.channels, tk.FftconvFusedKernel.signals,
            tk.FftconvFusedKernel.taps) == (ref_tk.C, ref_tk.B, ref_tk.K)
    assert tk.KERNEL_SCHEDULE.op_names == ref_tk.KERNEL_SCHEDULE.op_names


def test_table_run_prints_one_row_per_client(capsys):
    tk.run(reps=1, session=Session(TorchContext("cpu")))
    lines = capsys.readouterr().out.strip().splitlines()
    names = [line.split(",")[0] for line in lines]
    assert sorted(names) == sorted(tk.NAMES.values())
    assert all(float(line.split(",")[1]) > 0 for line in lines)


def test_entry_point_validates_tables_and_needs_the_card(capsys):
    assert port_run.TABLES == ["overhead", "tts", "plan_rigor", "backends",
                               "radix", "dtypes", "kernels", "lm_steps",
                               "serve"]
    assert port_run.main(["bogus"]) == 2
    assert "unknown table(s): bogus" in capsys.readouterr().err
    import torch
    if not torch.cuda.is_available():
        for table in ("kernels", "lm_steps", "serve"):
            with pytest.raises(RuntimeError, match="no CUDA GPU"):
                port_run.main([table])


def test_table_module_registers_its_clients():
    """In a fresh interpreter the table's clients are unknown until its
    module is imported; then ``run_suite`` on a CPU session runs them."""
    code = (
        "from repro_torch.core.client import TorchContext\n"
        "from repro_torch.core.suite import Session, SuiteSpec, run_suite\n"
        "spec = SuiteSpec(clients=('KernelFftconvFused',),\n"
        "                 extents=((64,),), kinds=('Outplace_Real',),\n"
        "                 warmups=0, repetitions=1, output=None)\n"
        "try:\n"
        "    spec.build_nodes()\n"
        "    raise SystemExit('registered without the table module')\n"
        "except KeyError:\n"
        "    pass\n"
        "import repro_torch.benchmarks.table_kernels  # noqa: F401\n"
        "rs = run_suite(spec, Session(TorchContext('cpu')))\n"
        "print([r.success for r in rs.query(op='validate')])\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[True]"
