"""``init_ms``: ``init_forward`` + ``init_inverse`` in set-up, host clock,
each ending in the client's synchronize (the planner's pick and the plan's
tables)."""


def read(run):
    return run.init_ms
