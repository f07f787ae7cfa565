"""``port_launches``: the port's kernel launches a pair, the sum of the
kernel modules' ``LAUNCHES`` counters over the window."""


def read(run):
    total = sum(run.launches.values())
    return total / run.pairs if total else None
