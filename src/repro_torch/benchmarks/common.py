"""Shared benchmark plumbing: every table declares a
:class:`repro_torch.core.suite.SuiteSpec` and runs it through
:func:`run_suite`; results print as ``name,us_per_call,derived`` CSV rows
(one per measured configuration) to stdout."""

from __future__ import annotations

import numpy as np

from ..core.suite import run_suite  # noqa: F401  (shared by every table)


def emit(name: str, us: float, derived: str = "") -> None:
    print(f"{name},{us:.2f},{derived}")


def rand_complex(shape, dtype=np.complex64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
