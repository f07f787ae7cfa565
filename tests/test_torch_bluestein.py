"""The port's chirp-Z path (``fft/bluestein.py``) and its two clients
against the reference package's.

Inputs come from a seeded numpy generator and go through both packages.
The reference's kernel engines run their Pallas kernels in interpret mode
(its complex128 Stockham kernel at tile 1, ROADMAP.md fault 1); the
port's run their kernels' plain versions on CPU tensors.  The chirp and
the filter spectrum are the same host float64 arrays in both.

Tolerance: rel-L2 <= 1e-5 (complex64) / 1e-12 (complex128) against the
reference and the suite's 1e-3 / 1e-8 against numpy.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from helpers.accuracy import REL_L2_TOL, rand_input, rel_l2

from repro.core import candidates as rc
from repro.core.client import Problem as RProblem
from repro.core.clients import jax_fft
from repro.fft import bluestein as ref_bluestein
from repro_torch.core import candidates as pc
from repro_torch.core.client import KINDS, Problem, TorchContext
from repro_torch.core.clients.torch_fft import (TorchBluestein,
                                                TorchChirpZPallas)
from repro_torch.core.suite import Session, SuiteSpec
from repro_torch.core.tree import BenchNode
from repro_torch.fft import bluestein

TOL = {"float": 1e-5, "double": 1e-12}
CDTYPE = {"float": (np.complex64, torch.complex64),
          "double": (np.complex128, torch.complex128)}


def rand_c(shape, precision, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(CDTYPE[precision][0])


def test_constants_are_the_reference():
    assert bluestein.ENGINES == ref_bluestein.ENGINES
    assert (bluestein.PALLAS_SINGLE_MAX_M, bluestein.SIXSTEP_MAX_M,
            bluestein._TABLES_MAX) == (ref_bluestein.PALLAS_SINGLE_MAX_M,
                                       ref_bluestein.SIXSTEP_MAX_M,
                                       ref_bluestein._TABLES_MAX)


@pytest.mark.parametrize("cpu", [False, True])
def test_resolve_engine_is_the_reference(cpu):
    """Both branches of "auto" (the card's: the reference on hardware; the
    CPU's: its interpret-mode branch) and every explicit engine, for n in
    1 ... 20000 and at the thresholds."""
    ns = list(range(1, 20001)) + [16384, 16385, 1 << 22, (1 << 23) + 1]
    for n in ns:
        assert bluestein.resolve_engine(n, "auto", cpu=cpu) == \
            ref_bluestein.resolve_engine(n, "auto", interpret=cpu), n
    for engine in ("stockham", "stockham_pallas", "sixstep"):
        for n in ns[::97] + ns[-4:]:
            assert bluestein.resolve_engine(n, engine, cpu=cpu) == \
                ref_bluestein.resolve_engine(n, engine, interpret=cpu)
    with pytest.raises(ValueError, match="chirp engine"):
        bluestein.resolve_engine(5, "fftw")


def test_chirp_tables_are_the_reference_and_bounded():
    """The host arrays equal the reference's exactly; the memo holds at
    most 32 entries, evicting the oldest."""
    bluestein._TABLES.clear()
    for precision in ("float", "double"):
        for n in (1, 2, 5, 19, 100, 361, 6859):
            for inverse in (False, True):
                for engine in ("stockham", "stockham_pallas"):
                    _, m = bluestein.resolve_engine(n, engine)
                    c, fb = bluestein.chirp_tables(n, m, CDTYPE[precision][1],
                                                   inverse)
                    rc_, rfb = ref_bluestein.chirp_tables(
                        n, m, CDTYPE[precision][0], inverse)
                    assert c.dtype == rc_.dtype and fb.dtype == rfb.dtype
                    assert np.array_equal(c, rc_) and np.array_equal(fb, rfb)
    assert len(bluestein._TABLES) == bluestein._TABLES_MAX
    first = next(iter(bluestein._TABLES))
    bluestein.chirp_tables(7, 13, torch.complex64)
    assert len(bluestein._TABLES) == bluestein._TABLES_MAX
    assert first not in bluestein._TABLES
    assert bluestein._complex_dtype(torch.float64) == torch.complex128
    assert bluestein._complex_dtype(torch.float32) == torch.complex64
    assert bluestein._complex_dtype(torch.complex64) == torch.complex64


@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("engine", ["stockham", "stockham_pallas", "sixstep"])
@pytest.mark.parametrize("n", [1, 2, 5, 19, 100, 361])
def test_fft_matches_reference(n, engine, precision):
    x = rand_c((3, n), precision, seed=n)
    xt = torch.from_numpy(x)
    tile = 1 if precision == "double" else None
    for inverse in (False, True):
        got = bluestein.fft(xt, inverse, engine=engine).numpy()
        want = np.asarray(jax.jit(functools.partial(
            ref_bluestein.fft, inverse=inverse, engine=engine, tile_b=tile,
            interpret=True))(x))
        oracle = np.fft.ifft(x) if inverse else np.fft.fft(x)
        assert got.dtype == x.dtype
        assert rel_l2(got, want) <= TOL[precision], (n, engine, inverse)
        assert rel_l2(got, oracle) <= REL_L2_TOL[precision], (n, engine,
                                                              inverse)


@pytest.mark.parametrize("precision", ["float", "double"])
def test_real_input_widens_by_its_width(precision):
    real = np.float32 if precision == "float" else np.float64
    x = np.random.default_rng(1).standard_normal((2, 19)).astype(real)
    got = bluestein.fft(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(ref_bluestein.fft)(x))
    assert got.dtype == want.dtype == CDTYPE[precision][0]
    assert rel_l2(got, want) <= TOL[precision]


def test_plan_holds_the_chirp_and_the_padded_engine():
    """A plan is the chirp, the filter spectrum and the padded engine's
    plans for its two directions; a call given it builds nothing, and a
    plan of another length, direction or dtype is refused."""
    for engine, kind in (("stockham_pallas", "Twiddles"),
                         ("sixstep", "Plan"), ("stockham", None)):
        plan = bluestein.make_plan(19, False, torch.complex128, "cpu", engine)
        assert plan.engine == engine and plan.chirp.shape == (19,)
        assert plan.spectrum.shape == (plan.m,)
        for p in (plan.forward, plan.backward):
            assert (p is None) if kind is None else type(p).__name__ == kind
        assert plan.backward is None or plan.backward.inverse
        x = torch.from_numpy(rand_c((2, 19), "double", 5))
        assert torch.equal(bluestein.fft(x, plan=plan),
                           bluestein.fft(x, engine=engine))
        with pytest.raises(ValueError, match="does not match"):
            bluestein.fft(x, True, plan=plan)
        with pytest.raises(ValueError, match="does not match"):
            bluestein.fft(x.to(torch.complex64), plan=plan)
    auto = bluestein.make_plan(19, False, torch.complex64, "cpu", "auto")
    assert auto.engine == "stockham"   # the CPU's "auto"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("precision", ["float", "double"])
@pytest.mark.parametrize("cls,key", [(TorchChirpZPallas, "chirpz_pallas"),
                                     (TorchBluestein, "bluestein")])
def test_clients_run_every_kind_and_match_reference(cls, key, kind,
                                                    precision):
    """``Session.run`` of each client on small problems of every kind
    (odd and even real axes, rank 1 and 2), every node round-trip
    validated, and the client's forward against the reference's under
    the same backend."""
    cpu = TorchContext("cpu")
    exts = ((19,), (12, 5), (3,))
    rs = Session(cpu).run(
        SuiteSpec(output=None, warmups=0, repetitions=1),
        nodes=[BenchNode(cls, Problem(e, kind, precision, 2)) for e in exts])
    assert not rs.failures(), [r.error for r in rs.failures()]
    assert len(rs.query(op="validate")) == len(exts)
    for ext in exts:
        problem = Problem(ext, kind, precision, 2)
        x = rand_input(problem, seed=7)
        client = cls(problem, cpu)
        client.allocate()
        client.init_forward()
        client.upload(x)
        client.execute_forward()
        assert client.plan.candidate.key() == key
        assert client.get_plan_size() > 0
        want = np.asarray(jax_fft.build_forward(
            RProblem(ext, kind, precision, 2), rc.Candidate(key))(x))
        got = client._spec.numpy()
        assert got.shape == want.shape
        assert rel_l2(got, want) <= TOL[precision], ext


def test_backend_supports_is_the_reference_at_the_caps():
    """The three backends' support rules against the reference's at and
    over the six-step and chirp-Z caps (2^23, 2^24, 2^24 + 1), and below
    them on every kind."""
    exts = ((1,), (2,), (3,), (4,), (19,), (6859,), (1 << 23,),
            ((1 << 23) + 1,), (1 << 24,), ((1 << 24) + 1,), (1 << 25,),
            (16, 1), (4, 4), (361, 361), (2, 1 << 22))
    for ext in exts:
        for kind in KINDS:
            for precision in ("float", "double"):
                port = Problem(ext, kind, precision)
                ref = RProblem(ext, kind, precision)
                for backend in ("sixstep", "chirpz_pallas", "bluestein"):
                    assert pc.backend_supports(backend, port) == \
                        rc.backend_supports(backend, ref), (backend, ext,
                                                            kind, precision)
    for n in (1, 2, 4, (1 << 23) - 1, 1 << 23, (1 << 23) + 1, 1 << 24,
              (1 << 24) + 1, 3 << 20):
        for backend in ("sixstep", "chirpz_pallas", "bluestein"):
            assert pc.axis_feasible(backend, n) == \
                rc.axis_feasible(backend, n), (backend, n)
    for n in [1 << k for k in range(26)] + [3, 12, 6859]:
        assert pc._sixstep_splits(n) == rc._sixstep_splits(n), n


def test_a_chirpz_node_over_the_cap_fails_before_any_transform():
    """Over 2^23 the pinned chirp-Z client fails in ``init_forward``; the
    node is never handed to ``torch.fft`` or the staged engine."""
    problem = Problem(((1 << 23) + 1,), "Outplace_Complex", "float")
    client = TorchChirpZPallas(problem, TorchContext("cpu"))
    with pytest.raises(ValueError, match="chirpz_pallas caps at"):
        client.init_forward()
