"""The gearshifft client protocol (paper Table 1) and the torch device
context.

Every benchmarked FFT backend is a *client* exposing exactly these
operations, each timed separately by the runner:

    constructor/destructor   allocate / destroy
    get_alloc_size / get_transfer_size / get_plan_size
    init_forward / init_inverse          (planning: build the plan's state)
    execute_forward / execute_inverse    (the measured hot op)
    upload / download                    (host <-> device transfer)
"""

from __future__ import annotations

import abc
from dataclasses import dataclass

import numpy as np
import torch

# The paper's four transform kinds (memory mode x data type)
KINDS = ("Inplace_Real", "Inplace_Complex", "Outplace_Real", "Outplace_Complex")
PRECISIONS = ("float", "double")


@dataclass(frozen=True)
class Problem:
    """One node of the benchmark tree: a fully specified FFT problem."""

    extents: tuple[int, ...]          # e.g. (128, 128, 128)
    kind: str = "Outplace_Real"       # one of KINDS
    precision: str = "float"          # 'float' | 'double'
    batch: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown kind {self.kind!r}; known: {KINDS}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r}")

    @property
    def rank(self) -> int:
        return len(self.extents)

    @property
    def inplace(self) -> bool:
        return self.kind.startswith("Inplace")

    @property
    def complex_input(self) -> bool:
        return self.kind.endswith("Complex")

    @property
    def real_dtype(self) -> np.dtype:
        return np.dtype(np.float32 if self.precision == "float" else np.float64)

    @property
    def input_dtype(self) -> np.dtype:
        if self.complex_input:
            return np.dtype(np.complex64 if self.precision == "float" else np.complex128)
        return self.real_dtype

    @property
    def n_elems(self) -> int:
        out = self.batch
        for v in self.extents:
            out *= v
        return out

    @property
    def signal_bytes(self) -> int:
        return self.n_elems * self.input_dtype.itemsize

    def signature(self) -> str:
        from .extents import format_extents
        return f"{format_extents(self.extents)}/{self.precision}/{self.kind}/b{self.batch}"


class TorchContext:
    """Library/device context: created once per suite run and timed
    separately (paper §2.2).

    ``device=None`` means ``cuda:0``; the CPU runs only when asked for by
    name.  ``create`` raises when the device is missing and, on the card,
    builds and loads the kernel library, so the build is part of the timed
    context create (like FFTW's library init).  ``options`` is the
    reference ``Context``'s mapping of client options (the service
    client's ``serve_burst``, ``serve_window_ms``, ...).
    """

    def __init__(self, device: str | torch.device | None = None,
                 options: dict | None = None):
        self.options = dict(options or {})
        self.device = torch.device("cuda:0" if device is None else device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", 0)
        self.device_kind = "?"

    def discover_kind(self) -> str:
        """The device kind that wisdom and cost tables are keyed by:
        ``"cpu"``, or the card's name.  Raises when the device is
        missing."""
        if self.device.type == "cpu":
            return "cpu"
        if self.device.type != "cuda":
            raise RuntimeError(f"unsupported device {self.device}")
        if not torch.cuda.is_available() \
                or self.device.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {self.device} is not available: no CUDA GPU found "
                "(pass device='cpu' to run on the CPU)")
        return torch.cuda.get_device_name(self.device)

    def create(self) -> None:  # timed once
        self.device_kind = self.discover_kind()
        if self.device.type == "cuda":
            from concurrent.futures import ThreadPoolExecutor

            from ..kernels import _build
            names = _build.sources()
            # one nvcc per source, all started together
            with ThreadPoolExecutor(max_workers=len(names)) as pool:
                list(pool.map(_build.library, names))

    def destroy(self) -> None:
        pass


class FFTClient(abc.ABC):
    """Table-1 interface. The runner drives exactly this sequence per run:

    allocate -> init_forward -> upload -> execute_forward -> init_inverse ->
    execute_inverse -> download -> destroy, all timed.
    """

    title = "abstract"

    def __init__(self, problem: Problem, context: TorchContext):
        self.problem = problem
        self.context = context

    # --- memory -----------------------------------------------------------
    @abc.abstractmethod
    def allocate(self) -> None: ...

    @abc.abstractmethod
    def destroy(self) -> None: ...

    def get_alloc_size(self) -> int:
        """Bytes of device signal buffers held."""
        return 0

    def get_transfer_size(self) -> int:
        """Bytes moved per upload/download."""
        return self.problem.signal_bytes

    def get_plan_size(self) -> int:
        """Bytes attributable to the plan."""
        return 0

    # --- planning ---------------------------------------------------------
    @abc.abstractmethod
    def init_forward(self) -> None: ...

    @abc.abstractmethod
    def init_inverse(self) -> None: ...

    # --- execution --------------------------------------------------------
    @abc.abstractmethod
    def execute_forward(self) -> None: ...

    @abc.abstractmethod
    def execute_inverse(self) -> None: ...

    # --- transfer ---------------------------------------------------------
    @abc.abstractmethod
    def upload(self, host_data: np.ndarray) -> None: ...

    @abc.abstractmethod
    def download(self) -> np.ndarray: ...
