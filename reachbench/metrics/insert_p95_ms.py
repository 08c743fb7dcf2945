"""insert_p95_ms: the 95th percentile over every insert batch of the
window, from the call until its edges are visible."""
from reachbench.readers import p95_ms


def read(run):
    return p95_ms(run.lat["insert"])
