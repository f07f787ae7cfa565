"""``exec_pair_p95_ms``: the 95th percentile of every pair's host-clock
duration in the window."""

from perfbench.yardstick import percentile


def read(run):
    return percentile(run.pair_s, 95) * 1e3
