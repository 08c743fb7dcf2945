"""BFS relax step: the CUDA kernel ``csrc/bfs_relax.cu`` and its plain
PyTorch version.

One level of the batched BFS (``core.query.relax``): row x of the
(n_cap, Q) bool output is set on lane q when a live edge ``tails[e] ->
heads[e] = x`` has its tail on lane q's frontier and, with ``m_cut``
(Q,), an edge slot ``e < m_cut[q]``.  It replaces no TPU kernel: on the
TPU the step was left to XLA.  The plain version (``relax_plain``) reads
the host for the frontier's edges (``nonzero``), gathers their rows and
scatters them by a byte max; the kernel makes one pass over the frontier
plane and one over the edge slots, with no host read and no gathered
block (the source says how).

``relax_op`` is the torch custom op ``repro_torch::bfs_relax``,
registered when this module is imported (``_build.register_op``): the
CUDA implementation launches the kernel, the CPU one is ``relax_plain``,
and the fake one gives the (n_cap, Q) bool plane, so that ``torch.export``
takes a BFS round with the op whole and no data-dependent shape.
``bfs_relax.launches`` counts the CUDA steps (each a memset and two
launches: the row pass and ``relax_kernel``).  ``waits_on_host`` says
which path makes the host wait; ``row_mode`` picks the kernel's row
loads.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: how the kernel reads and writes a row (``Mode`` in the source): bytes,
#: or 16-byte words (Q % 16 == 0, the frontier's base 16-byte aligned)
BYTES, VEC16 = 0, 1


def row_mode(q: int, address: int) -> int:
    """The row loads the kernel takes for a frontier of ``q`` lanes whose
    first byte is at ``address``."""
    return VEC16 if q % 16 == 0 and address % 16 == 0 else BYTES


#: the base alignment in bytes the kernel's slot loads need of each edge
#: array: 16-byte loads of tails and heads, 4-byte loads of live bytes
EDGE_ALIGN = {"tails": 16, "heads": 16, "live": 4}


def waits_on_host(device) -> bool:
    """Whether a relax step on ``device`` makes the host wait: the plain
    version reads the frontier's edge count (``nonzero``), the kernel on
    a CUDA device reads nothing."""
    return torch.device(device).type != "cuda"


def relax_plain(frontier, tails, heads, live, m_cut, n_cap: int,
                ftype=torch.int8) -> torch.Tensor:
    """The kernel's function in PyTorch ops.  Only the edges whose tail is
    on some lane's frontier are gathered (``nonzero``); their lane rows,
    cut per lane by ``m_cut``, are OR-ed into their heads by
    ``index_reduce_("amax")`` on ``ftype`` (any integer type gives the
    same plane)."""
    eidx = torch.nonzero(frontier.any(1)[tails] & live).squeeze(1)
    contrib = frontier[tails[eidx]]
    if m_cut is not None:
        contrib &= eidx[:, None] < m_cut[None, :]
    nxt = torch.zeros((n_cap, frontier.shape[1]), dtype=ftype,
                      device=frontier.device)
    nxt.index_reduce_(0, heads[eidx], contrib.to(ftype), "amax",
                      include_self=True)
    return nxt > 0


# -------------------------------------------------------------- the op
_SCHEMA = ("(Tensor frontier, Tensor tails, Tensor heads, Tensor live, "
           "Tensor? m_cut, int n_cap, ScalarType ftype) -> Tensor")


def _relax_cuda(frontier, tails, heads, live, m_cut, n_cap, ftype):
    """The kernel on CUDA operands: a 2-d bool frontier of ``n_cap`` rows,
    int64 tails and heads and a bool live mask of one length, each based
    as ``EDGE_ALIGN`` says (``relax_edges`` makes fresh ones), an int32
    ``m_cut`` of one entry a lane, all on one device; raises on anything
    else.  Operands that are not contiguous are copied."""
    dev = frontier.device
    named = dict(frontier=frontier, tails=tails, heads=heads, live=live,
                 m_cut=m_cut)
    for name, x in named.items():
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, frontier on {dev}: "
                             "the operands must share a device")
    if frontier.dtype != torch.bool or frontier.dim() != 2 or \
            frontier.shape[0] != n_cap:
        raise ValueError(f"frontier must be a ({n_cap}, Q) bool plane, got "
                         f"{frontier.dtype} of shape {tuple(frontier.shape)}")
    m = tails.shape[0] if tails.dim() == 1 else -1
    for name, x, dtype in (("tails", tails, torch.int64),
                           ("heads", heads, torch.int64),
                           ("live", live, torch.bool)):
        if x.dtype != dtype or x.dim() != 1 or x.shape[0] != m:
            raise ValueError(f"{name} must be ({m},) {dtype}, got "
                             f"{x.dtype} of shape {tuple(x.shape)}")
    q = frontier.shape[1]
    if m_cut is not None and (m_cut.dtype != torch.int32
                              or tuple(m_cut.shape) != (q,)):
        raise ValueError(f"m_cut must be ({q},) int32, got {m_cut.dtype} "
                         f"of shape {tuple(m_cut.shape)}")
    out = frontier.new_empty((n_cap, q))
    if n_cap * q == 0:
        return out
    frontier, tails, heads, live = (x.contiguous() for x in
                                    (frontier, tails, heads, live))
    if m_cut is not None:
        m_cut = m_cut.contiguous()
    for name, x in (("tails", tails), ("heads", heads), ("live", live)):
        if x.data_ptr() % EDGE_ALIGN[name]:
            raise ValueError(f"{name} must start on a {EDGE_ALIGN[name]}"
                             f"-byte boundary, got address {x.data_ptr()}")
    # scratch: a bit a row, set where some lane of the row is
    on = torch.empty(-(-n_cap // 32), dtype=torch.int32, device=dev)
    lib = _build.load("bfs_relax")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    p = _build.ptr
    with torch.cuda.device(dev):
        err = lib.bfs_relax(p(frontier), p(tails), p(heads), p(live),
                            p(m_cut), p(out), p(on), n_cap, q, m,
                            row_mode(q, frontier.data_ptr()), stream)
    _build.check(lib, err, "relax_kernel")
    bfs_relax.launches += 1
    return out


def _relax_fake(frontier, tails, heads, live, m_cut, n_cap, ftype):
    return frontier.new_empty((n_cap, frontier.shape[1]), dtype=torch.bool)


relax_op = _build.register_op("bfs_relax", _SCHEMA, relax_plain,
                              _relax_cuda, _relax_fake)


def bfs_relax(frontier, tails, heads, live, m_cut, n_cap: int,
              ftype=torch.int8) -> torch.Tensor:
    """(n_cap, Q) bool: one BFS level of the Q lanes of ``frontier``, as
    ``relax_plain`` computes it: one step of ``csrc/bfs_relax.cu`` for
    CUDA operands (the op ``relax_op``), ``relax_plain`` for CPU ones.  A
    fresh plane on every call."""
    return relax_op(frontier, tails, heads, live, m_cut, n_cap, ftype)


bfs_relax.launches = 0
