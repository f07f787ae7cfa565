"""``exec_mfu``: the whole pair's share of the chip's peak, in %: the
pair's bound from the problem alone (``yardstick.pair_bound_s``: one read
of the input and one write of the output of each transform at 3.35 TB/s,
or its flops at 67 TFLOP/s, whichever is larger) over the traced run's
time a pair (host clock: the window over its pairs).  It reads the same
work whatever implements the transform."""

from perfbench.yardstick import pair_bound_s


def read(run):
    return pair_bound_s(run.problem) / (run.window_s / run.pairs) * 100
