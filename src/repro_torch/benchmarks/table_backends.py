"""Paper Fig. 6: FFT-only runtime per backend, 1D/2D/3D: the
vendor-library comparison mapped onto the port's clients (``TorchFFT`` =
cuFFT through ``torch.fft``, ``TorchFourStep`` / ``TorchStockham`` /
``TorchBluestein`` = the plain-torch baselines, ``TorchStockhamPallas`` =
the hand-written Stockham kernel, ``TorchSixStep`` = the composed large-N
path, ``TorchFft2Pallas`` = the fused rank-2 kernel against the separable
per-axis path, ``TorchChirpZPallas`` = chirp-Z on the kernels).  The row
names are the reference table's, with the port's client titles."""

from __future__ import annotations

from dataclasses import replace

from ..core.suite import Session, SuiteSpec
from .common import emit, run_suite

# plan_cache=False keeps the paper's per-run planning measurement
SPECS = {
    "1d": SuiteSpec(clients=("TorchFFT", "TorchStockham", "TorchFourStep",
                             "TorchBluestein", "TorchStockhamPallas",
                             "TorchSixStep"),
                    extents=("256", "4096", "65536"),
                    kinds=("Outplace_Real",), precisions=("float",),
                    warmups=1, plan_cache=False, output=None),
    "2d": SuiteSpec(clients=("TorchFFT", "TorchStockham", "TorchFft2Pallas",
                             "TorchStockhamPallas"),
                    extents=("64x64", "256x256"),
                    kinds=("Outplace_Real",), precisions=("float",),
                    warmups=1, plan_cache=False, output=None),
    "3d": SuiteSpec(clients=("TorchFFT", "TorchStockham", "TorchFourStep",
                             "TorchBluestein", "TorchStockhamPallas"),
                    extents=("16x16x16", "32x32x32"),
                    kinds=("Outplace_Real",), precisions=("float",),
                    warmups=1, plan_cache=False, output=None),
    # non-pow2 classes: the mixed-radix kernel on radix357, chirp-Z on the
    # kernels on oddshape, against the vendor path and the staged chirp
    "nonpow2": SuiteSpec(clients=("TorchFFT", "TorchStockhamPallas",
                                  "TorchChirpZPallas", "TorchBluestein"),
                         extents=("3072", str(19 ** 3)),
                         kinds=("Outplace_Real",), precisions=("float",),
                         warmups=1, plan_cache=False, output=None),
}


def run(reps: int = 3, session: Session | None = None) -> None:
    """Every spec through ``Session.run`` (a fresh Session on ``cuda:0``
    unless one is given); one CSV row of mean ``execute_forward`` us per
    node that ran.  A node its backend cannot take (the Stockham kernel on
    the 7-smooth-free 6859) is a failed node and has no row."""
    for tag, spec in SPECS.items():
        results = run_suite(replace(spec, repetitions=reps), session)
        for a in results.aggregate_named(op="execute_forward"):
            emit(f"backend/{tag}/{a.library}/{a.extents}", a.mean * 1e3)
