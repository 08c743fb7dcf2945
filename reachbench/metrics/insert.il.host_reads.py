"""insert.il.host_reads: ``repro_torch.sync.*`` spans (host waits) inside
``repro_torch.insert.il``, an insert call."""
from reachbench.il_spans import count_in_il


def read(run):
    return count_in_il(run, "repro_torch.sync.")
