"""insert.host_reads: the program's host waits an insert call: its
reads of the device and copies that wait for it, one
``repro_torch.sync.*`` span each (a library call that waits more than
once inside, such as ``isin``, counts once)."""
from reachbench.spans import span_count


def read(run):
    return span_count(run, "insert", "repro_torch.sync.")
