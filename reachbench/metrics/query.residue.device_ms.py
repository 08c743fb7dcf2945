"""query.residue.device_ms: device ms launched inside the program's
residue (``repro_torch.query.residue``: the reads of the label phase's
outputs, the residue BFS's prologue and rounds), per query call: the
card's busy time from the end of the residue's first read to the span's
end (``reachbench.spans``)."""
from reachbench.spans import phase_device_ms


def read(run):
    return phase_device_ms(run, "residue")
