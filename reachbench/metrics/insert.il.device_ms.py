"""insert.il.device_ms: device-busy ms inside ``repro_torch.insert.il``
(the interval family's two MIN fixpoints), an insert call."""
from reachbench.il_spans import il_device_ms


def read(run):
    return il_device_ms(run)
