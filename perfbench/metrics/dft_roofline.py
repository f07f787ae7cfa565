"""``dft_roofline``: the dft kernel (``csrc/dft.cu``) as a share of its
roofline, in %: the bound of its launches (one read and one write of each
launch's rows, 5 n log2 n flops a row; shapes from the ``dft_matmul``
module's ``LAUNCH_SHAPES``) over their device time."""

from perfbench.metrics_common import kernel_roofline


def read(run):
    return kernel_roofline(run, source="dft", module="dft_matmul")
