"""Named spans inside the serving path, on the profiler's clock.

A span is a profiler range over a block of the serving path, so it lands
in the same trace as the CUDA kernels and shares their clock; no second
clock or exporter exists.  Spans record while a ``torch.profiler``
records, and only then: the profiler is the switch.  Otherwise ``span``
returns one shared ``nullcontext`` after one check of the profiler's
state, because a live range costs microseconds even with no profiler
running::

    from torch.profiler import profile

    with profile() as prof:
        server.query(u, v)
    prof.export_chrome_trace("serve.json")

A span is an operator-scoped range (``cpu_op`` in the Chrome trace, like
the ``aten::`` operators it encloses), so a reader of the trace finds it
among the host's operators.  Span names start with ``repro_torch.``;
spans nest by the thread's call stack.  A ``repro_torch.sync.<site>``
span encloses one call that makes the host wait for the card (a read of
the device, or a copy to it) and nothing else, so their count is the
number of such calls; a library call may wait more than once inside
(``isin``, ``sync.delete_match``).  No span sits inside a function that
``torch.export`` takes: spans wrap the calls to those functions.  So
``repro_torch.sync.bfs_edges`` encloses a whole BFS round where its relax
step reads the host (the plain relax, on the CPU: the count of the
frontier's edges, inside the exported round); the relax kernel on the
card reads nothing, and the span does not open there.
"""
from __future__ import annotations

import contextlib

from torch.autograd import _profiler_enabled as _recording

try:
    from torch._C._profiler import _RecordFunctionFast as _range
except ImportError:                     # an older torch: a user range
    from torch.profiler import record_function as _range

_NULL = contextlib.nullcontext()


def enabled() -> bool:
    """Whether ``span`` records: a profiler is recording."""
    return _recording()


def span(name: str):
    """A context manager: a profiler range named ``name`` while a
    profiler records, the shared null context otherwise."""
    return _range(name) if _recording() else _NULL
