"""Build and load the port's CUDA kernels.

Each ``*.cu`` under ``repro_torch/csrc/`` is compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with :mod:`ctypes`.
Nothing builds at import time: the first call that needs a library builds
it into ``build/kernels/`` at the root of the checkout, keyed by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
unchanged source is compiled once and an edited header rebuilds every
library.  Libraries of different sources build concurrently when several
threads ask for them.  A failed build raises with nvcc's own error output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``stockham`` for ``csrc/stockham.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError(f"nvcc not found on PATH or at {default}: "
                       "the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str, target: Path) -> None:
    """Run nvcc on ``csrc/<name>.cu``; it writes to a temporary file that is
    renamed to ``target`` on success."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.parent / f"{target.stem}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}{proc.stdout}")
    target.with_suffix(".log").write_text(proc.stderr + proc.stdout)  # ptxas report
    os.replace(tmp, target)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                _compile(name, target)
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
        return lib


def build_log(name: str) -> str:
    """nvcc's ``-Xptxas -v`` report of the last build of ``name``."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
