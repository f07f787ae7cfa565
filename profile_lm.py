#!/usr/bin/env python3
"""The LM phases of ``chip_smoke.py`` alone, on one GPU.

    python3 profile_lm.py [--cells L3,L4] [--train T1,T2] [--sharded]
                          [--tests]

Runs ``chip_smoke.run_lm_serve`` over the named cells of
``chip_smoke.LM_CELLS`` (all by default; an unknown label is an error;
``--cells none`` runs none); with ``--train`` the training phase,
``chip_smoke.run_train``, over the named cells of
``chip_smoke.TRAIN_CELLS`` (``all`` for every one), then the checkpoint
restart and the ``lm_steps`` table; with ``--sharded`` the sharded
phase, ``chip_smoke.run_sharded`` (M1, M2 on a one-rank (1, 1) mesh, T1's
row beside M1's where ``--train`` ran T1, then the dry run's cells);
then with ``--tests`` the card tests
``-k lm`` of ``tests/test_torch_cuda.py``.  Prints one JSON row a cell,
as ``chip_smoke.py`` does.  Exits nonzero if a cell's check or a test
fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="",
                    help="comma-separated labels of chip_smoke.LM_CELLS")
    ap.add_argument("--train", default="",
                    help="comma-separated labels of chip_smoke.TRAIN_CELLS, "
                         "or 'all'")
    ap.add_argument("--sharded", action="store_true",
                    help="then run the sharded phase (M1, M2, dry run)")
    ap.add_argument("--tests", action="store_true",
                    help="then run the LM card tests")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    def pick(arg, table):
        if arg == "all":
            return table
        if arg == "none":
            return ()
        by_label = {c[0]: c for c in table}
        unknown = [x for x in arg.split(",") if x not in by_label]
        if unknown:
            ap.error(f"unknown cells {unknown}; known: {sorted(by_label)}")
        return tuple(by_label[x] for x in arg.split(","))
    cells = pick(args.cells or "all", cs.LM_CELLS)
    train = pick(args.train, cs.TRAIN_CELLS) if args.train else None

    import torch
    if not torch.cuda.is_available():
        print("profile_lm: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.emit({"python": sys.version.split()[0], "torch": torch.__version__,
             "cuda": torch.version.cuda, **cs.card_info()})
    rc = 0
    t0 = time.perf_counter()
    try:
        if cells:
            cs.run_lm_serve(torch.device("cuda", 0), cells)
    except AssertionError:
        traceback.print_exc()
        rc = 1
    cs.emit({"lm_serve_phase_s": time.perf_counter() - t0})
    trained = {}
    if train is not None:
        t0 = time.perf_counter()
        try:
            trained = cs.run_train(torch.device("cuda", 0), train)
        except AssertionError:
            traceback.print_exc()
            rc = 1
        cs.emit({"train_phase_s": time.perf_counter() - t0})
    if args.sharded:
        t0 = time.perf_counter()
        try:
            _, dry = cs.run_sharded(torch.device("cuda", 0),
                                    trained.get("T1"))
            cs.finish_dryrun(dry)
        except AssertionError:
            traceback.print_exc()
            rc = 1
        finally:
            cs._stop_children()
        cs.emit({"sharded_phase_s": time.perf_counter() - t0})
    if args.tests:
        r = subprocess.run([sys.executable, "-m", "pytest", "-q",
                            "--noconftest", "-m", "cuda",
                            "tests/test_torch_cuda.py", "-k", "lm"],
                           cwd=ROOT, env=dict(os.environ, PYTHONPATH="src"))
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
