"""insert.il.rounds: ``repro_torch.insert.round`` spans inside
``repro_torch.insert.il`` (both interval fixpoints), an insert call."""
from reachbench.il_spans import count_in_il


def read(run):
    return count_in_il(run, "repro_torch.insert.round")
