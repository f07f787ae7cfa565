"""Quickstart: benchmark two FFT problems through the declarative Suite API
and print the standardized CSV (paper §2.2 usage example), on the H100.

  PYTHONPATH=src python examples/torch_quickstart.py             # cuda:0
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Writes ``result.csv`` and ``quickstart.toml`` in the working directory.
"""

import argparse

from repro_torch.core.client import TorchContext
from repro_torch.core.suite import Session, SuiteSpec

# the paper's CLI example:  gearshifft_clfft -e 128x128 1024 -r */float/*/Inplace_Real
SPEC = SuiteSpec(clients=("TorchFFT", "TorchFourStep"),
                 extents=("128x128", "1024"),
                 select="*/float/*/Inplace_Real",
                 warmups=1, repetitions=3, output="result.csv",
                 verbose=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0; 'cpu' on a host "
                         "without a card)")
    args = ap.parse_args(argv)

    results = Session(TorchContext(args.device)).run(SPEC)
    print("\naggregated (execute_forward):")
    for row in results.aggregate(op="execute_forward"):
        lib, ext, prec, kind, rigor, op, mean, sd, n = row
        print(f"  {lib:13s} {ext:>9s} {kind:14s} {mean:8.3f} ms ± {sd:.3f}")
    print("\nfull per-op rows written to result.csv")
    SPEC.save("quickstart.toml")
    print("spec saved: replay with  "
          "python -m repro_torch.core.cli --config quickstart.toml")
    return results


if __name__ == "__main__":
    main()
