"""insert_eps: edges inserted in the window over the whole window."""
from reachbench.readers import rate


def read(run):
    return rate(run, "insert")
