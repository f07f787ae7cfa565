"""``fft4step_roofline``: the four-step kernel (``csrc/fft4step.cu``) as a
share of its roofline, in %: the bound of its launches (one read and one
write of each launch's rows, 5 n log2 n flops a row; shapes from the
``fft4step`` module's ``LAUNCH_SHAPES``) over their device time."""

from perfbench.metrics_common import kernel_roofline


def read(run):
    return kernel_roofline(run, source="fft4step", module="fft4step")
