"""query.host_reads: the program's host waits a query call: its
reads of the device and copies that wait for it, one
``repro_torch.sync.*`` span each (a library call that waits more than
once inside, such as ``isin``, counts once)."""
from reachbench.spans import span_count


def read(run):
    return span_count(run, "query", "repro_torch.sync.")
