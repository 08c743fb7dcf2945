"""engine.bfs_rounds: residue BFS rounds a query call
(``repro_torch.query.residue.round`` spans, over every chunk)."""
from reachbench.spans import span_count


def read(run):
    return span_count(run, "query", "repro_torch.query.residue.round")
