"""query.label.device_ms: device ms launched inside the program's label
phase (``repro_torch.query.label``: the inputs' copy, the verdict kernel,
the attribution counts and the compaction), per query call: the card's
busy time from the span's start to the end of the read that follows it
(``reachbench.spans``)."""
from reachbench.spans import phase_device_ms


def read(run):
    return phase_device_ms(run, "label")
