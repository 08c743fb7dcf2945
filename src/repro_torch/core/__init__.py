from .dbl import DBLIndex  # noqa: F401
from .graph import Graph, make_graph  # noqa: F401
