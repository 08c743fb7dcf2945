"""DBL core: DAG-free dynamic reachability index (the paper's contribution)."""
from . import bitset, graph, labels, planes, propagate, query, select, update  # noqa: F401
from .dbl import DBLIndex  # noqa: F401
from .graph import Graph, make_graph  # noqa: F401
from .query import PackedLabels, pack_labels  # noqa: F401
