"""device.idle_share.insert: 100 x (1 - device busy / wall) inside the
insert calls."""
from reachbench.readers import range_idle_share


def read(run):
    return range_idle_share(run, "insert")
