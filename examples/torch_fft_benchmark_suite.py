"""The full gearshifft-style suite run on the H100: every baseline client
x transform kind x extent class, with planner rigors and wisdom; the
reference's ``examples/fft_benchmark_suite.py`` with the port's clients.

Demonstrates the programmatic Suite API: declarative ``SuiteSpec``s (extent
sweeps included) executed by one shared ``Session``, result sets
concatenated and written once.  A failed node is recorded, not fatal: the
failures are ``expected_failures``, the nodes whose backend
``support_matrix`` marks unsupported (the plain Stockham client on a length
that is not a power of two, ...) but for the plain four-step client's.

  PYTHONPATH=src python examples/torch_fft_benchmark_suite.py [-o suite.csv]
  PYTHONPATH=src python examples/torch_fft_benchmark_suite.py --device cpu
"""

import argparse
import os
import tempfile
from dataclasses import replace

from repro_torch.core.candidates import axis_engine_n
from repro_torch.core.client import TorchContext
from repro_torch.core.plan import PlanRigor
from repro_torch.core.results import (PLAN_CACHE_COLUMN, PLAN_SOURCE_COLUMN,
                                      columns_for)
from repro_torch.core.suite import (ResultSet, Session, SuiteSpec, SweepSpec,
                                    support_matrix)
from repro_torch.core.wisdom import generate
from repro_torch.fft import fourstep

MAIN_SPEC = SuiteSpec(
    clients=("TorchFFT", "TorchStockham", "TorchFourStep", "TorchBluestein"),
    sweeps=(SweepSpec("powerof2", rank=1, min_exp=6, max_exp=12),
            SweepSpec("powerof2", rank=3, min_exp=3, max_exp=5),
            SweepSpec("radix357", rank=1, count=4, start=96),
            SweepSpec("oddshape", rank=1, count=3)),
    kinds=("Outplace_Real", "Outplace_Complex", "Inplace_Real"),
    precisions=("float", "double"),
    warmups=1, plan_cache=False, output=None, verbose=True)

RIGOR_SPEC = SuiteSpec(
    clients=("TorchPlanned",), extents=("1024", "4096"),
    kinds=("Outplace_Real",), precisions=("float",),
    warmups=1, plan_cache=False, output=None, verbose=True)


def unsupported_nodes(spec: SuiteSpec) -> set:
    """``(client, extents, kind, precision)`` of every node of ``spec``
    whose client's backend ``support_matrix`` marks unsupported at the
    node's extents."""
    out = set()
    for node in spec.build_nodes():
        backend = getattr(node.client_cls, "backend_filter", None)
        if backend is None:
            continue
        p = node.problem
        row, = (r for r in support_matrix(
            kinds=(p.kind,), precisions=(p.precision,),
            probes={p.rank: p.extents}) if r["backend"] == backend)
        if not row["supported"]:
            out.add(failure_key(node.client_cls.title, p.extents, p.kind,
                                p.precision))
    return out


def _fourstep_takes(n: int) -> bool:
    """Does the plain four-step engine factor ``n`` (every prime factor
    at most its largest radix)?"""
    for q in range(2, fourstep.MAX_RADIX + 1):
        while n % q == 0:
            n //= q
    return n == 1


def expected_failures(spec: SuiteSpec) -> set:
    """The nodes of ``spec`` that fail: those ``unsupported_nodes`` lists,
    less the plain four-step client's nodes at lengths its engine factors
    though the planner's rule (13-smooth) does not offer it there, which
    the reference's FourStep client runs as well (19, 361, 6859)."""
    problems = {failure_key(n.client_cls.title, n.problem.extents,
                            n.problem.kind, n.problem.precision): n.problem
                for n in spec.build_nodes()}
    out = set()
    for key in unsupported_nodes(spec):
        p = problems[key]
        if key[0] == "TorchFourStep" and all(
                _fourstep_takes(axis_engine_n(p, i)) for i in range(p.rank)):
            continue
        out.add(key)
    return out


def failure_key(client: str, extents, kind: str, precision: str) -> tuple:
    ext = extents if isinstance(extents, str) else \
        "x".join(str(v) for v in extents)
    return (client, ext, kind, precision)


def one_schema(results: list) -> list:
    """The runs with one set of columns: the rigor runs' rows carry the
    ``plan_source`` column (they read wisdom), the main run's leave it
    empty, so ``ResultSet.concat`` takes them together."""
    cols = columns_for(*(any(c in r.columns for r in results)
                         for c in (PLAN_CACHE_COLUMN, PLAN_SOURCE_COLUMN)))
    return [ResultSet(r.rows, cols) for r in results]


def main(argv=None) -> ResultSet:
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default="suite.csv")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0; 'cpu' on a host "
                         "without a card)")
    args = ap.parse_args(argv)

    session = Session(TorchContext(args.device))
    results = [session.run(replace(MAIN_SPEC, repetitions=args.reps))]

    # planner rigors on a canonical subset, with fresh wisdom
    with tempfile.TemporaryDirectory() as td:
        wpath = os.path.join(td, "w.json")
        generate([(1024,), (4096,)], wpath, rigor=PlanRigor.MEASURE,
                 device=args.device)
        for rigor in (PlanRigor.ESTIMATE, PlanRigor.MEASURE,
                      PlanRigor.WISDOM_ONLY):
            results.append(session.run(replace(
                RIGOR_SPEC, repetitions=args.reps, rigor=rigor.value,
                wisdom=wpath)))

    combined = ResultSet.concat(one_schema(results))
    path = combined.save(args.output)
    print(f"\nwrote {combined.n_rows} rows to {path} "
          f"({combined.n_failures} failed configs, e.g. TorchStockham on "
          f"non-pow2 extents — recorded, not fatal)")
    return combined


if __name__ == "__main__":
    main()
