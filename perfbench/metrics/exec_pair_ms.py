"""``exec_pair_ms``: the window's time over the forward+inverse pairs it
finished (host clock)."""


def read(run):
    return run.window_s / run.pairs * 1e3
