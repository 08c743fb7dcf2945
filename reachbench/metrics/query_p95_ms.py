"""query_p95_ms: the 95th percentile over every query batch of the
window, from the call to its answers (a lazy rebuild run inside the call
counts)."""
from reachbench.readers import p95_ms


def read(run):
    return p95_ms(run.lat["query"])
