"""The control and the planted faults: the check's other side.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 2 --client control|program|stale|identity|half|altered

Runs the cell's set-up, window and check once a seed in one process, with
the system under test replaced as ``--client`` says, and prints one JSON
line a seed with each checked number beside its limit:

* ``program``: the port's client, as ``run.py`` runs it (the lower
  readings that the limits are set from);
* ``control``: the plain reference in the program's place, in the
  precision below the configuration's (``reference.dft.CONTROL``: TF32
  for float), which has to come out not correct;
* ``stale`` (the forward returns its state unchanged: the spectrum of its
  first call), ``identity`` (the forward returns its input), ``half``
  (half of the batch left out: its rows stay zero), ``altered`` (one value
  of each spectrum negated where it is produced): the port's client with
  its forward broken, each of which has to come out not correct.

Needs a CUDA card; the CPU tests under ``tests/`` run the same clients at
a size a test run holds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


class ReferenceClient:
    """The plain reference behind the Table-1 calls the harness makes."""

    def __init__(self, cell, problem, device, precision: str):
        from perfbench import harness, loader

        ref = loader.reference(cell.config["reference"])
        self.problem, self.device = problem, torch.device(device)
        self.dft = ref.Dft(problem.extents, real=not problem.complex_input,
                           precision=precision)
        self.dtype = harness.input_dtype(problem)
        self.plan = None
        self._buf = self._spec = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def allocate(self):
        p = self.problem
        self._buf = torch.zeros((p.batch, *p.extents), dtype=self.dtype,
                                device=self.device)

    def init_forward(self):
        pass

    def init_inverse(self):
        pass

    def upload(self, host):
        self._buf.copy_(torch.from_numpy(host))
        self._sync()

    def execute_forward(self):
        self._spec = self.dft.forward(self._buf)
        self._sync()

    def execute_inverse(self):
        self._buf = self.dft.inverse(self._spec).to(self.dtype)
        self._sync()

    def destroy(self):
        self._buf = self._spec = None


class FaultClient:
    """The port's client with its forward broken in one way (``FAULTS``);
    every other call is the client's own."""

    FAULTS = ("stale", "identity", "half", "altered")

    def __init__(self, inner, fault: str):
        if fault not in self.FAULTS:
            raise ValueError(f"fault {fault!r} not in {self.FAULTS}")
        self.inner, self.fault = inner, fault
        self._stale = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def execute_forward(self):
        inner = self.inner
        x = inner._buf
        if self.fault == "stale" and self._stale is not None:
            inner._spec = self._stale
        elif self.fault == "identity":
            p = inner.problem
            width = p.extents[-1] if p.complex_input else p.extents[-1] // 2 + 1
            inner._spec = x.to(torch.complex64 if p.precision == "float"
                               else torch.complex128)[..., :width]
        else:
            inner.execute_forward()
            if self.fault == "stale":
                self._stale = inner._spec.clone()
            elif self.fault == "half":
                inner._spec[inner._spec.shape[0] // 2:] = 0
            elif self.fault == "altered":
                spec = inner._spec
                at = (spec.shape[0] // 3,) + (1,) * (spec.ndim - 1)
                spec[at] = -spec[at]
        if inner.device.type == "cuda":
            torch.cuda.synchronize(inner.device)


def make_client(kind: str):
    """A ``make_client`` for ``harness.run_cell``."""
    from perfbench import harness

    if kind == "program":
        return harness.program_client
    if kind == "control":
        def control(cell, problem, device):
            from perfbench import loader
            ref = loader.reference(cell.config["reference"])
            return ReferenceClient(cell, problem, device,
                                   ref.CONTROL[problem.precision])
        return control
    return lambda cell, problem, device: FaultClient(
        harness.program_client(cell, problem, device), kind)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="the control and faults")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True,
                        help="comma-separated seeds, one run each")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--client", default="control",
                        choices=("program", "control", *FaultClient.FAULTS))
    args = parser.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(p))
    from perfbench import harness, loader

    if not torch.cuda.is_available():
        print("perfbench control: no CUDA card", file=sys.stderr)
        return 2
    cell = loader.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.run_cell(cell, seed, args.seconds, False, t0,
                               make_client=make_client(args.client))
        correct, failed, checks = harness.verdict(run)
        print(json.dumps({"control": args.client, "workload": cell.name,
                          "seed": seed, "correct": correct, "failed": failed,
                          "pairs": run.pairs, "checks": checks,
                          "checked_pairs": run.errors,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
