"""``torch_pass_ms``: device time a pair in operations the port's CUDA
sources did not launch (torch's own kernels, copies and sets: the engine's
passes around the kernels), from the profiler's trace."""


def read(run):
    if run.trace is None:
        return None
    torch_s = sum(op.seconds for op in run.trace.ops if op.source is None)
    return torch_s / run.pairs * 1e3
