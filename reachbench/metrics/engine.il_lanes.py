"""engine.il_lanes: lanes a query batch answered negative by the interval
rule and not by BL (``EngineStats.prune_hits["il"]`` over the window's
query batches): lanes the residue BFS would take without the family."""


def read(run):
    calls = len(run.lat["query"])
    return run.counters["engine"]["prune_hits"]["il"] / calls \
        if calls else None
