"""engine.residue_lanes: lanes a query batch that went to the residue BFS
(``EngineStats.prune_hits["bfs"]`` over the window's query batches)."""


def read(run):
    calls = len(run.lat["query"])
    return run.counters["engine"]["prune_hits"]["bfs"] / calls \
        if calls else None
