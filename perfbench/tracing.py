"""Reading the profiler's trace of a run's window.

The window runs under ``torch.profiler`` (host and CUDA activity).  The
harness marks it with user annotations: ``perfbench.window`` around the
whole window, ``execute_forward`` / ``execute_inverse`` around each call,
and ``perfbench.snapshot`` around the copies it takes of a checked pair's
input and outputs.  From the trace this module takes:

* the device operations (kernels, copies, sets) inside the window, less
  those the harness's own copies launched (matched by correlation id);
* which of them are the port's kernels: a kernel is the port's when its
  name is a ``__global__`` function of the port's ``csrc/`` sources, read
  from those sources at run time, each with the source file it comes from
  (``fft4step`` for ``csrc/fft4step.cu``);
* the seconds in which an operation ran (the union of their intervals);
* the idle gaps, each named by what the host was doing at its middle (the
  innermost host event, annotation or op, that spans it).
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

WINDOW = "perfbench.window"
SNAPSHOT = "perfbench.snapshot"
NAME_CHARS = 100
TOP = 10

_GLOBAL = re.compile(r"__global__\b")
_LAST_NAME = re.compile(r"([A-Za-z_]\w*)\s*$")
_ANON = "(anonymous namespace)::"


def _strip_launch_bounds(head: str) -> str:
    """``head`` without its ``__launch_bounds__(...)`` (nested parentheses
    and all)."""
    at = head.find("__launch_bounds__")
    if at < 0:
        return head
    depth, i = 0, head.index("(", at)
    for i in range(i, len(head)):
        depth += {"(": 1, ")": -1}.get(head[i], 0)
        if depth == 0:
            break
    return head[:at] + head[i + 1:]


def port_kernels(csrc: Path) -> dict[str, str]:
    """``__global__`` function name -> the stem of the source that defines
    it, over ``csrc/*.cu`` and ``csrc/*.cuh``."""
    names: dict[str, str] = {}
    for path in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        text = path.read_text()
        for m in _GLOBAL.finditer(text):
            head = _strip_launch_bounds(text[m.end(): m.end() + 2000])
            found = _LAST_NAME.search(head[: head.find("(")])
            if found:
                names[found.group(1)] = path.stem
    return names


def kernel_ident(name: str) -> str:
    """The function name of a device event's name: demangled
    (``void ns::f<T>(args)`` -> ``f``) or mangled (``_Z3fooPf`` -> ``foo``)."""
    if name.startswith("_Z"):
        m = re.match(r"_Z(\d+)", name)
        return name[m.end(): m.end() + int(m.group(1))] if m else ""
    head = name.replace(_ANON, "").split("(")[0].split("<")[0].strip()
    return head.split()[-1].split("::")[-1] if head else ""


@dataclass
class DeviceOp:
    name: str
    start: float   # seconds in the trace's time base
    end: float
    source: str | None   # the port's csrc stem, or None: not the port's

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    """What a window's trace holds, in seconds."""

    window_s: float
    ops: list[DeviceOp]
    gaps: list[tuple[str, float]] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        """Seconds in which at least one operation ran."""
        return sum(b - a for a, b in _busy_intervals(self.ops))

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten host
        activities that the longest idle time fell in, in seconds."""
        by_op: dict[str, float] = defaultdict(float)
        for op in self.ops:
            by_op[op.name[:NAME_CHARS]] += op.seconds
        by_gap: dict[str, float] = defaultdict(float)
        for name, seconds in self.gaps:
            by_gap[name[:NAME_CHARS]] += seconds
        top = lambda d: [[k, v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def _busy_intervals(ops: list[DeviceOp]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for op in sorted(ops, key=lambda o: o.start):
        if merged and op.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], op.end)
        else:
            merged.append([op.start, op.end])
    return [(a, b) for a, b in merged]


def _name_gaps(host: list[tuple[float, float, str]],
               gaps: list[tuple[float, float]]) -> list[tuple[str, float]]:
    """Each gap named by the innermost host event spanning its middle."""
    host = sorted(host)
    starts = [h[0] for h in host]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        name = "harness loop"
        # the latest-starting event that still spans ``mid``; host events
        # on one thread nest, so it is the innermost
        for j in range(i - 1, max(i - 4096, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        named.append((name, b - a))
    return named


def from_kineto(events, kernels: dict[str, str]) -> Trace:
    """A :class:`Trace` of the window from the profiler's raw events
    (``prof.profiler.kineto_results.events()``).  A device operation is
    the harness's own when the runtime call that launched it (the host
    event of the same correlation id) lies in a ``perfbench.snapshot``
    annotation."""
    from torch.autograd import DeviceType

    window = None
    snapshots: list[tuple[float, float]] = []
    host: list[tuple[float, float, str]] = []
    launches: list[tuple[float, int]] = []
    device = []
    for ev in events:
        name = ev.name()
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((name, start, end, ev.correlation_id()))
        elif name == WINDOW:
            window = (start, end)
        else:
            if name == SNAPSHOT:
                snapshots.append((start, end))
            elif ev.correlation_id():
                launches.append((start, ev.correlation_id()))
            host.append((start, end, name))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} annotation")
    harness_ids = {cid for t, cid in launches
                   if any(a <= t <= b for a, b in snapshots)}
    w0, w1 = window
    ops = [DeviceOp(name, start, min(end, w1), kernels.get(kernel_ident(name)))
           for name, start, end, cid in device
           if w0 <= start <= w1 and cid not in harness_ids]
    busy = _busy_intervals(ops)
    edges = [w0, *[x for ab in busy for x in ab], w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return Trace(window_s=w1 - w0, ops=ops, gaps=_name_gaps(host, gaps))
