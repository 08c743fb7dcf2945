"""insert.fixpoint_rounds: label fixpoint rounds an insert call
(``repro_torch.insert.round`` spans, over every plane)."""
from reachbench.spans import span_count


def read(run):
    return span_count(run, "insert", "repro_torch.insert.round")
