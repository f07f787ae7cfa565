"""Arithmetic shared by metric readers."""

from __future__ import annotations

from .yardstick import bound_s, launch_work


def kernel_roofline(run, source: str, module: str) -> float | None:
    """The bound of the launches the kernel module ``module`` counted over
    the window (its ``LAUNCH_SHAPES``: ``(n, rows, dtype)`` a launch) over
    the device time of the kernels defined in ``csrc/<source>.*``, in %.
    None where the trace holds none of them."""
    if run.trace is None:
        return None
    device_s = sum(op.seconds for op in run.trace.ops if op.source == source)
    shapes = run.launch_shapes.get(module, {})
    if device_s <= 0 or not shapes:
        return None
    least = 0.0
    for (n, rows, dtype), count in shapes.items():
        flops, nbytes = launch_work(n, rows, dtype)
        least += count * bound_s(flops, nbytes)
    return least / device_s * 100
