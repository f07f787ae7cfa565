"""Noise-aware regression gate between two BENCH trajectory documents.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_diff \\
        baseline.json candidate.json
    PYTHONPATH=src python -m repro_torch.benchmarks.bench_diff \\
        baseline.json candidate.json --smoke --md bench_diff.md

The reference's ``tools/bench_diff.py`` over the port's comparison core
(``core/compare.py``), with its flags and exit codes.  Rows are aligned by
(mode, backend, extent, kind, precision, rank, devices), so a document of
either package, schema 1 or 2, diffs against any other.  A slowdown only
counts as a regression when it clears every gate: the pooled standard
error sigma test (from the rows' ``sd_ms``/``n``; no information for
1-rep rows), the relative min-effect floor and the absolute floor.
``--smoke`` selects the loose preset for 1-rep runs, where only
feasibility losses and order-of-magnitude slowdowns are trustworthy.
The batch is not part of the key: diff documents of one batch.

Prints the markdown delta report (also written to ``--md``) and exits 1
when the candidate regresses the baseline, 2 on an unreadable document.
"""

from __future__ import annotations

import argparse
import sys

from ..core.compare import (SMOKE_THRESHOLDS, BenchFormatError, Thresholds,
                            diff_docs, load_bench, markdown_report)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("baseline", help="baseline BENCH_*.json")
    p.add_argument("candidate", help="candidate BENCH_*.json")
    p.add_argument("--md", default=None,
                   help="also write the markdown report to this path")
    p.add_argument("--smoke", action="store_true",
                   help="smoke-grade thresholds (1-rep grids: gate only on "
                        "feasibility losses and order-of-magnitude "
                        "slowdowns)")
    p.add_argument("--sigma", type=float, default=None,
                   help="noise gate: |delta| must exceed sigma x pooled "
                        "standard error (default 3)")
    p.add_argument("--min-rel", type=float, default=None,
                   help="min-effect floor as a fraction of the baseline "
                        "(default 0.10; smoke preset 4.0)")
    p.add_argument("--min-abs-ms", type=float, default=None,
                   help="absolute floor in metric units (default 0.05)")
    p.add_argument("--fail-on-missing", action="store_true",
                   help="also exit nonzero when baseline rows are missing "
                        "from the candidate (same-grid diffs)")
    p.add_argument("--no-fail", action="store_true",
                   help="always exit 0 (report-only mode)")
    args = p.parse_args(argv)

    base = SMOKE_THRESHOLDS if args.smoke else Thresholds()
    th = Thresholds(
        sigma=args.sigma if args.sigma is not None else base.sigma,
        min_rel=args.min_rel if args.min_rel is not None else base.min_rel,
        min_abs_ms=(args.min_abs_ms if args.min_abs_ms is not None
                    else base.min_abs_ms),
        name=base.name if (args.sigma is None and args.min_rel is None
                           and args.min_abs_ms is None) else "custom",
    )
    try:
        doc_a = load_bench(args.baseline)
        doc_b = load_bench(args.candidate)
    except (OSError, BenchFormatError) as e:
        print(f"bench_diff: {e}", file=sys.stderr)
        return 2

    res = diff_docs(doc_a, doc_b, th)
    report = markdown_report(res)
    print(report, end="")
    if args.md:
        with open(args.md, "w") as f:
            f.write(report)
    if args.no_fail:
        return 0
    if res.has_regression:
        return 1
    if args.fail_on_missing and res.count("removed"):
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
