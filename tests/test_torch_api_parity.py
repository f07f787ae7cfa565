"""Every public name of the reference package has a counterpart in the
port, and the reference's last deprecated names behave as its own.

For each module of ``src/repro/`` the public top-level names it defines
(functions, classes, assignments; not its imports) are looked up on the
matching port module (``core/clients/jax_fft.py`` is the port's
``core/clients/torch_fft.py``).  A client class is matched by its title
after the title map (the reference's ``XlaFFTClient``, title ``XlaFFT``,
is the port's ``TorchFFT``), any other class by its name.
``EXCEPTIONS`` is the whole of what the port does not carry over, each
with its reason.

Then: the deprecated shims (``wisdom.generate`` / ``main``,
``Benchmark.run_nodes``) warn ``DeprecationWarning`` as the reference's
do, ``Benchmark(...).run_nodes`` gives ``run_nodes``'s rows, each engine's
``ifft`` is its ``fft(..., inverse=True)``, and the public builders
(``build_forward``, ``build_inverse``, ``forward_fn``, ``generate``) run
on ``cuda:0`` unless asked for the CPU.
"""

from __future__ import annotations

import ast
import importlib
import json
import os
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core.candidates import Candidate
from repro_torch.core.client import Problem, TorchContext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "src", "repro")

#: Reference modules whose port has another name.
MODULES = {"core/clients/jax_fft.py": "core/clients/torch_fft.py"}

#: The reference's client titles and the port's.
TITLES = {"jaxfft": "torchfft", "XlaFFT": "TorchFFT",
          "Stockham": "TorchStockham", "FourStep": "TorchFourStep",
          "FourStepPallas": "TorchFourStepPallas",
          "StockhamPallas": "TorchStockhamPallas", "SixStep": "TorchSixStep",
          "Fft2Pallas": "TorchFft2Pallas", "ChirpZPallas": "TorchChirpZPallas",
          "Bluestein": "TorchBluestein", "Planned": "TorchPlanned",
          "DistFFT1D": "TorchDistFFT1D", "DistFFTND": "TorchDistFFTND",
          "ServeFFT": "TorchServeFFT"}

_PALLAS = "a Pallas TPU kernel; the port's is the CUDA kernel of its " \
    "kernels/<name>/ops.py (csrc/)"
_TILE = "the Pallas grid's batch tile; the port's wrappers size theirs " \
    "from shared memory (default_tile_b)"
_CAP = "a TPU VMEM cap of the planner; the port's caps live under its " \
    "kernel modules' names (stockham_max_n, ONE_BLOCK_N, fft4step MAX_N, ...)"
_JAX = "JAX-only: a sharding or engine type with no torch counterpart"

#: (reference module, name) -> why the port has no counterpart; a module
#: name alone stands for the whole module.
EXCEPTIONS = {
    ("fft/distributed.py", "sharding_for"): _JAX,
    ("fft/distributed.py", "Engine"): _JAX,
    ("models/layers.py", "Params"): _JAX + " (the port's is models.model."
                                           "Params, an nn.Module)",
    ("core/client.py", "Context"): "the port's context is TorchContext",
    ("roofline/analysis.py", "ICI_BW"): "the port's is COLL_BW (a rank's "
                                         "link, not the TPU's ICI)",
    ("roofline/hlo_parse.py", None): "the port counts ops in "
                                     "roofline/op_count.py, not XLA's HLO",
    ("kernels/stockham_pallas/stockham_pallas.py", "stockham_pallas"):
        _PALLAS,
    ("kernels/stockham_pallas/stockham_pallas.py", "apply_stages"):
        _PALLAS + " (the stage loop: block_fft in csrc/stockham_stages.cuh,"
        " modelled by ref.py)",
    ("kernels/stockham_pallas/stockham_pallas.py", "DEFAULT_TILE_B"): _TILE,
    ("kernels/fft2_pallas/fft2_pallas.py", "fft2_pallas"): _PALLAS,
    ("kernels/fft2_pallas/fft2_pallas.py", "DEFAULT_TILE_B"): _TILE,
    ("kernels/fft4step/fft4step.py", "fft4step"): _PALLAS,
    ("kernels/fft4step/fft4step.py", "DEFAULT_TILE_B"): _TILE,
    ("kernels/dft_matmul/dft_matmul.py", "dft_matmul"): _PALLAS,
    ("kernels/dft_matmul/dft_matmul.py", "DEFAULT_TILE_B"): _TILE,
    ("kernels/fftconv/fftconv.py", "fftconv_kernel"): _PALLAS,
    ("kernels/stockham_pallas/ops.py", "VMEM_BUDGET_BYTES"): _CAP,
    ("core/candidates.py", "STOCKHAM_PALLAS_MAX_N"): _CAP,
    ("core/candidates.py", "STOCKHAM_PALLAS_VMEM_N"): _CAP,
    ("core/candidates.py", "FOURSTEP_PALLAS_MAX_N"): _CAP,
    ("core/candidates.py", "FFT2_PALLAS_MAX_ELEMS"): _CAP,
    ("core/candidates.py", "FFT2_PALLAS_VMEM_ELEMS"): _CAP,
}


def _modules() -> list[str]:
    out = []
    for dp, _, files in os.walk(REF):
        out += [os.path.relpath(os.path.join(dp, f), REF)
                for f in files if f.endswith(".py")]
    return sorted(out)


def _defined(path: str) -> tuple[set, dict]:
    """The public names ``path`` defines at top level, and its client
    classes' titles (a class whose body assigns ``title``)."""
    names, titles = set(), {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
        if isinstance(node, ast.ClassDef):
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and any(
                        getattr(t, "id", None) == "title"
                        for t in stmt.targets):
                    titles[node.name] = ast.literal_eval(stmt.value)
    return {n for n in names if not n.startswith("_")}, titles


def _port_module(rel: str):
    rel = MODULES.get(rel, rel)
    name = "repro_torch." + rel[:-3].replace("/", ".")
    return importlib.import_module(name.removesuffix(".__init__"))


@pytest.mark.parametrize("rel", _modules())
def test_every_public_name_has_a_counterpart(rel):
    if (rel, None) in EXCEPTIONS:
        assert not os.path.exists(os.path.join(ROOT, "src", "repro_torch",
                                               rel))
        return
    names, titles = _defined(os.path.join(REF, rel))
    mod = _port_module(rel)
    port_titles = {getattr(v, "title", None) for v in vars(mod).values()
                   if isinstance(v, type)}
    missing = []
    for name in sorted(names):
        if (rel, name) in EXCEPTIONS:
            assert not hasattr(mod, name), f"{name} is ported: drop the " \
                "exception"
        elif titles.get(name) in TITLES:
            if TITLES[titles[name]] not in port_titles:
                missing.append(f"{name} (title {titles[name]})")
        elif not hasattr(mod, name):
            missing.append(name)
    assert not missing, f"{rel}: {missing}"


def test_every_exception_names_a_reference_name():
    for (rel, name), why in EXCEPTIONS.items():
        assert why
        path = os.path.join(REF, rel)
        assert os.path.exists(path), rel
        if name is not None:
            assert name in _defined(path)[0], (rel, name)


# --------------------------------------------------------------------------
# the deprecated shims
# --------------------------------------------------------------------------
def test_wisdom_shims_warn_and_plan(tmp_path):
    from repro_torch.core import wisdom

    path = str(tmp_path / "w.json")
    with pytest.warns(DeprecationWarning, match="deprecated"):
        w = wisdom.generate([(16,), (8, 8)], path,
                            rigor=wisdom.PlanRigor.MEASURE,
                            kinds=("Outplace_Complex",), device="cpu")
    assert len(w) == 2
    with open(path) as f:
        assert len(json.load(f)) == 2
    out = str(tmp_path / "m.json")
    with pytest.warns(DeprecationWarning, match="deprecated"):
        wisdom.main(["-o", out, "--max-exp", "3", "--device", "cpu"])
    with open(out) as f:
        # 2, 4, 8 and 2x2x2, both kinds
        assert len(json.load(f)) == 8
    assert wisdom.DEFAULT_PATH.endswith(os.path.join("repro_torch",
                                                     "wisdom.json"))


def test_benchmark_shim_gives_run_nodes_rows():
    from repro_torch.core import benchmark
    from repro_torch.core.clients.torch_fft import TorchFFT, TorchStockham
    from repro_torch.core.results import ResultWriter
    from repro_torch.core.tree import BenchNode

    nodes = [BenchNode(TorchFFT, Problem((16,), "Outplace_Real", "float")),
             BenchNode(TorchStockham, Problem((12,), "Outplace_Complex"))]
    cfg = benchmark.BenchmarkConfig(warmups=0, repetitions=2)
    shim = benchmark.Benchmark(TorchContext("cpu"), cfg)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = shim.run_nodes(nodes)
    want = benchmark.run_nodes(nodes, context=TorchContext("cpu"),
                               config=cfg, writer=ResultWriter())
    key = lambda r: (r.library, r.extents, r.kind, r.run, r.op, r.success,
                     r.error)
    assert [key(r) for r in got.rows] == [key(r) for r in want.rows]
    assert got.n_failures == want.n_failures == 1   # stockham at 12
    assert got.columns == want.columns
    assert set(benchmark.OPS) <= {r.op for r in got.rows}


# --------------------------------------------------------------------------
# ifft and the public builders
# --------------------------------------------------------------------------
@pytest.mark.parametrize("engine,n", [("stockham", 64), ("fourstep", 60),
                                      ("sixstep", 1024), ("bluestein", 19)])
def test_ifft_is_the_inverse_fft(engine, n):
    mod = importlib.import_module(f"repro_torch.fft.{engine}")
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((3, n))
                          + 1j * rng.standard_normal((3, n))
                          ).astype(np.complex64))
    got = mod.ifft(x)
    assert torch.equal(got, mod.fft(x, inverse=True))
    want = np.fft.ifft(x.numpy(), axis=-1)
    assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) < 1e-5


def test_public_builders_run_on_the_cpu_when_asked():
    from repro_torch.core.clients import torch_fft

    problem = Problem((8, 12), "Outplace_Complex", "float", 2)
    x = torch.randn(2, 8, 12, dtype=torch.complex64)
    for backend in ("xla", "fourstep", "fourstep_pallas"):
        cand = Candidate(backend)
        fwd = torch_fft.build_forward(problem, cand, "cpu")
        y = fwd(x)
        assert torch.allclose(y, torch.fft.fftn(x, dim=(-2, -1)),
                              atol=1e-4)
        assert torch.equal(torch_fft.forward_fn(problem, cand, "cpu")(x), y)
        back = torch_fft.build_inverse(problem, cand, "cpu")(y)
        assert torch.allclose(back, x, atol=1e-5)


def test_public_builders_default_to_the_card(monkeypatch, tmp_path):
    from repro_torch.core import wisdom
    from repro_torch.core.clients import torch_fft

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    problem = Problem((16,), "Outplace_Complex")
    for build in (torch_fft.build_forward, torch_fft.build_inverse,
                  torch_fft.forward_fn):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(problem, Candidate("xla"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            wisdom.generate([(16,)], str(tmp_path / "w.json"))
    assert not os.path.exists(tmp_path / "w.json")
