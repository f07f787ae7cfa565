"""gearshifft-style CLI of the port: a thin adapter from argparse to
:class:`SuiteSpec`.

    python -m repro_torch.core.cli -e 128x128 1024 -r '*/float/*/Inplace_Real' \
        --client TorchFFT TorchStockhamPallas

reproduces `gearshifft_cufft -e 128x128 1024 -r */float/*/Inplace_Real`.
One process can host several "library binaries" (clients); selecting a
single client mimics the per-library executables gearshifft builds.

Every invocation is parsed into one serializable
:class:`repro_torch.core.suite.SuiteSpec` and executed by a
:class:`repro_torch.core.suite.Session` on ``cuda:0`` (no card: the run
raises, as ``TorchContext().create()`` does), the same path the benchmark
tables and Python callers take; a Python caller that wants another device
passes its own ``session`` to :func:`main`.  Two flags expose the spec
itself:

* ``--config suite.toml`` loads a spec file (TOML, or JSON by extension),
  gearshifft's ``-f extents_file`` analogue; any explicitly passed CLI
  flag overrides the file's value.
* ``--dump-config [path|-]`` emits the fully resolved spec of this
  invocation (TOML, or JSON for ``*.json``) and exits without running, so
  any CLI run can be saved, replayed with ``--config``, and diffed.

Clients come from the registry (filled by
``repro_torch.core.clients.torch_fft``, ``dist_fft`` and ``serve_fft`` at
import; extra modules can be
pulled in with ``--load pkg.mod`` or the spec's ``load`` list), results
stream through a CSV or JSONL sink (chosen by ``--format`` or the output
extension), and the plan cache is on by default: ``--no-plan-cache``
restores the paper's per-run planning measurement and the original CSV
schema.
"""

from __future__ import annotations

import argparse
import importlib
from dataclasses import replace
from typing import Sequence

from .client import KINDS, PRECISIONS
from .plan import PlanRigor
from .registry import client_names
from .suite import Session, SuiteSpec
from .clients import (dist_fft, serve_fft,  # noqa: F401  (fills the registry)
                      torch_fft)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="repro-torch-bench", description=__doc__)
    p.add_argument("-e", "--extents", nargs="+", default=["32x32x32"],
                   help="extents specs like 128x128 or 1024")
    p.add_argument("-r", "--run", default=None,
                   help="wildcard selection title/precision/extents/kind")
    p.add_argument("--client", nargs="+", default=["TorchFFT"],
                   choices=client_names(), help="client 'binaries' to run")
    p.add_argument("--load", nargs="*", default=[], metavar="MODULE",
                   help="extra modules to import (register more clients)")
    p.add_argument("--kinds", nargs="+", default=list(KINDS), choices=KINDS)
    p.add_argument("--precisions", nargs="+", default=["float"], choices=PRECISIONS)
    p.add_argument("--rigor", default="estimate",
                   choices=[r.value for r in PlanRigor])
    p.add_argument("--warmups", type=int, default=1)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--error-bound", type=float, default=1e-5)
    p.add_argument("--wisdom", default=None, help="wisdom JSON path")
    p.add_argument("--no-plan-cache", action="store_true",
                   help="rebuild every run (paper-faithful planning cost; "
                        "restores the original CSV schema)")
    p.add_argument("-o", "--output", default="result.csv")
    p.add_argument("--format", default=None, choices=["csv", "jsonl"],
                   help="result sink format (default: by output extension)")
    p.add_argument("-b", "--batch", type=int, default=1)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--config", default=None, metavar="SPEC",
                   help="load a SuiteSpec file (.toml/.json); explicitly "
                        "passed flags override its values")
    p.add_argument("--dump-config", nargs="?", const="-", default=None,
                   metavar="PATH",
                   help="emit the resolved spec (TOML, or JSON for *.json; "
                        "'-' = stdout) and exit without running")
    return p


#: argparse dest -> SuiteSpec field (``no_plan_cache`` is handled separately
#: because its sense is inverted).
_ARG_TO_FIELD = {
    "extents": "extents", "run": "select", "client": "clients",
    "load": "load", "kinds": "kinds", "precisions": "precisions",
    "batch": "batch", "rigor": "rigor", "warmups": "warmups",
    "reps": "repetitions", "error_bound": "error_bound", "wisdom": "wisdom",
    "output": "output", "format": "format", "verbose": "verbose",
}


def spec_from_args(args: argparse.Namespace,
                   only: set[str] | None = None,
                   base: SuiteSpec | None = None) -> SuiteSpec:
    """Map parsed args onto a SuiteSpec.

    With ``base`` (a ``--config`` spec), only the arg dests named in
    ``only`` (the flags the user explicitly passed) override the file.
    """
    vals = {}
    for arg, fld in _ARG_TO_FIELD.items():
        if only is not None and arg not in only:
            continue
        vals[fld] = getattr(args, arg)
    if only is None or "no_plan_cache" in only:
        vals["plan_cache"] = not args.no_plan_cache
    if base is not None:
        return replace(base, **vals)
    return SuiteSpec(**vals)


def _explicit_args(argv: Sequence[str] | None) -> set[str]:
    """Dests of the flags actually present on the command line (parsed with
    all defaults suppressed, so absent flags leave no attribute)."""
    p = build_parser()
    for a in p._actions:
        a.default = argparse.SUPPRESS
    ns, _ = p.parse_known_args(argv)
    return set(vars(ns))


def main(argv: Sequence[str] | None = None,
         session: Session | None = None) -> int:
    """Run one invocation; ``session`` defaults to a fresh Session on
    ``cuda:0``."""
    # --load/--config run before the main parse so the clients they register
    # appear in --client choices
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--load", nargs="*", default=[])
    pre.add_argument("--config", default=None)
    known, _ = pre.parse_known_args(argv)
    for mod in known.load:
        importlib.import_module(mod)
    base = None
    if known.config:
        base = SuiteSpec.from_file(known.config)
        base.load_modules()

    args = build_parser().parse_args(argv)
    if base is not None:
        spec = spec_from_args(args, only=_explicit_args(argv), base=base)
    else:
        spec = spec_from_args(args)

    if args.dump_config is not None:
        if args.dump_config == "-":
            print(spec.to_toml(), end="")
        else:
            spec.save(args.dump_config)
            print(f"wrote spec to {args.dump_config}")
        return 0

    nodes = spec.build_nodes()
    if not nodes:
        print("no benchmarks selected")
        return 1
    result = (session if session is not None else Session()).run(
        spec, nodes=nodes)
    print(f"wrote {result.n_rows} rows to {result.path}; "
          f"{result.n_failures} failures")
    summ = result.summary()
    print(f"plan time: {summ['plan_time_ms']:.0f} ms total "
          f"({summ['plan_time_cold_ms']:.0f} ms cold build)")
    if result.plan_stats is not None:
        s = result.plan_stats
        print(f"plan cache: {s.hits} hits, {s.misses} misses, "
              f"cold build {s.cold_ms:.0f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
