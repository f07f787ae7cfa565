"""Finding a cell's parts by the names in ``BENCHMARK.json``.

Everything that belongs to one cell, configuration, traffic mix or metric
sits in a file of its own, found by name, so that a cell or a metric is
added by adding files:

* ``configs/<config>.json``: the FFT problem class (extents, precision),
  its source and the plain reference that checks it (``reference/<name>.py``);
* ``traffic/<traffic>.json``: the parameters the one generator reads
  (kind, bytes of input, client, rigor, warm-up and checked pairs);
* ``workloads/<cell>.json``: the plan the cell expects and the limits of
  the numbers that decide ``correct``;
* ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

from . import yardstick

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    spec: dict              # workloads/<cell>.json
    end_to_end: tuple[str, ...]
    per_layer: tuple[str, ...]

    def problem(self, batch: int | None = None) -> yardstick.Problem:
        """The cell's problem; ``batch`` overrides the traffic's size (the
        CPU tests run a cell's path at a size they can hold)."""
        extents = tuple(int(e) for e in self.config["extents"])
        kind, precision = self.traffic["kind"], self.config["precision"]
        if batch is None:
            batch = yardstick.batch_for(extents, kind, precision,
                                        int(self.traffic["input_bytes"]))
        return yardstick.Problem(extents, kind, precision, batch)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; raises KeyError when the
    file has no such cell."""
    bench = benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=_json(root / config["file"]),
        traffic=_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        spec=_json(HERE / "workloads" / f"{name}.json"),
        end_to_end=tuple(m["name"] for m in bench["end_to_end"]
                         if _applies(m, name)),
        per_layer=tuple(m["name"] for m in bench["per_layer"]
                        if _applies(m, name)))


def _module(path: Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    mod_name = "perfbench._loaded." + re.sub(r"\W", "_", str(
        path.relative_to(HERE).with_suffix("")))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    return _module(HERE / "metrics" / f"{metric}.py").read


def reference(name: str) -> ModuleType:
    """``reference/<name>.py``."""
    return _module(HERE / "reference" / f"{name}.py")
