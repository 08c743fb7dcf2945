"""engine.rho: the share of the window's queries that the QueryEngine's
label phase answered (``EngineStats.prune_hits``: every family but the
BFS residue), in percent."""


def read(run):
    hits = run.counters["engine"]["prune_hits"]
    total = sum(hits.values())
    return 100.0 * (total - hits["bfs"]) / total if total else None
