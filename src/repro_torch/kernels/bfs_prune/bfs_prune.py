"""BFS admit plane: the CUDA kernel ``csrc/bfs_prune.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/bfs_prune/bfs_prune.py``
``bfs_admit_plane`` (body ``_make_kernel``, line 41):

    admit[x, q] = BL_in(x) ⊆ BL_in(v_q) ∧ BL_out(v_q) ⊆ BL_out(x)
                  ∧ ¬(DL_out(u_q) ∩ DL_in(x) ≠ ∅)

with the DL term gated off for lanes whose edge-count cutoff
(``m_cut < m_total``) or tombstone cutoff (``d_cut < d_total``) is stale.
Output (n_cap, Q) int8.  At the serving shapes the kernel is bound by its
integer operations (2·Wb + Wd + 2 per output byte), at small Q by bytes
(the n*Q output plus one read of three vertex planes).  Both admit kernels
share one tile (``csrc/admit_tile.cuh``): a thread keeps a group of 4 or 8
lanes' query-side words in registers, folds the three tests into one
accumulator with one 3-input logic op per word, and writes each row's
bytes of its lanes with one packed store; see the sources for the design.

``bfs_admit_plane`` (through ``admit_op``, on one pre-combined freshness
row) launches the kernel for CUDA tensors and takes ``admit_plain`` for
CPU tensors.  ``bfs_admit_plane.launches`` counts kernel launches.

The streamed kernel ``csrc/bfs_prune_streamed.cu`` replaces
``bfs_admit_plane_streamed`` (body ``_make_streamed_kernel``, line 135):
the same plane with the vertex axis streamed in chunks and the cutoffs
pre-combined into one freshness row.  ``bfs_admit_plane_streamed`` and
``admit_streamed_plain`` are its wrapper and plain version.

Each kernel is a torch custom op, ``repro_torch::bfs_admit_plane`` and
``repro_torch::bfs_admit_plane_streamed`` (``admit_op``,
``streamed_admit_op``), registered when this module is imported
(``_build.register_op``): the CUDA
implementation launches the kernel, the CPU one is the plain version, and
a fake implementation gives the (n_cap, Q) int8 output, so that
``torch.export`` traces the residue through the kernel as one node.  Both
take the cutoffs as one pre-combined 0/1 freshness row, never as host
integers.

The launch geometry of both kernels is computed here (``admit_geometry``)
and passed to them, so that the CPU tests reach it: which thread of which
block writes which (row, lane group) of the plane (``admit_coverage``
mirrors the kernels' index arithmetic), the chunk size and the shared
memory it takes.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import query as Q
from repro_torch.kernels import _build
from repro_torch.kernels.dbl_query.dbl_query import (_aligned, _check,
                                                     _check_pairs)

#: threads per block of the grid kernel and of the streamed kernel (the
#: sources' __launch_bounds__ caps)
GRID_THREADS = 256
STREAM_THREADS = 512
#: the grid kernel's grid-stride walk: blocks per SM
GRID_BLOCKS_PER_SM = 2
#: the streamed kernel's chunk: at most this many rows
MAX_N_BLOCK = 1024
#: the shared memory a block's staged lane side may take; a Q with more
#: lanes at these label widths spreads over more lane slabs
LANE_SMEM_BYTES = 48 * 1024


@dataclass(frozen=True)
class AdmitGeometry:
    """Launch geometry of an admit kernel.  Thread ``t`` of block
    ``(bx, by)`` takes lane group ``span * slab + t % span`` (lanes
    ``lanes * group`` onward) and row offset ``t // span``; it is idle
    when the offset is ``>= rows`` or the group ``>= groups``.  The grid
    kernel's slab is ``by`` and its rows are ``bx * rows + offset``
    stepping by ``blocks * rows``; the streamed kernel's block walks items
    ``bx, bx + blocks, ...`` (chunk ``item % nchunks`` of slab ``item //
    nchunks``) and the rows ``offset, offset + rows, ...`` of each
    ``n_block``-row chunk."""
    threads: int
    lanes: int      # lanes per thread: 4 or 8
    groups: int     # lane groups per row, ceil(Q / lanes)
    span: int       # lane groups a block covers
    rows: int       # rows a block covers per step
    slabs: int      # ceil(groups / span)
    blocks: int     # the grid's x extent (streamed: persistent blocks)
    n_block: int    # streamed: rows per chunk; 0 for the grid kernel
    pack: bool      # Q % lanes == 0 and the output aligned: packed stores
    vec: bool       # the planes' bases 16-byte aligned: vector loads
    smem: int       # dynamic shared memory per block, bytes


def lanes_per_thread(q: int, wb: int, wd: int, streamed: bool) -> int:
    """The grid kernel takes 8 lanes a thread (one 64-bit store per row,
    half the vertex-row loads per byte) when Q is a multiple of 8 and the
    lane side stays small in registers (2·Wb + Wd <= 6 words a lane); the
    streamed kernel, whose rows come from shared memory, and every other
    case take 4 (one 32-bit store, or bytes for a ragged Q).  The sources
    compile only these pairs of width and lane count."""
    small = wb >= 1 and wd >= 1 and 2 * wb + wd <= 6
    return 8 if not streamed and q % 8 == 0 and small else 4


def pick_n_block(n_cap: int, sms: int, wb: int, wd: int,
                 lane_bytes: int = 0) -> int:
    """Rows per streamed chunk: n_cap spread over about ``sms`` persistent
    blocks, a multiple of 4 in [4, ``MAX_N_BLOCK``], and no larger than
    the shared-memory ring allows beside ``lane_bytes`` of lane side.
    Every block has work and each pays its chunk barriers as few times as
    n_cap allows: one chunk per block up to ``sms * MAX_N_BLOCK`` rows (at
    the LJ shape, n_cap 60 000 on 132 SMs, 456 rows), the ring overlapping
    chunks beyond that."""
    fit = (_build.MAX_SMEM_BYTES - lane_bytes) // (8 * max(1, 2 * wb + wd))
    nb = min(-(-n_cap // sms) + 3, MAX_N_BLOCK, fit)
    return max(4, nb // 4 * 4)


def admit_geometry(n_cap: int, q: int, wb: int, wd: int, sms: int, *,
                   streamed: bool = False, n_block: int | None = None,
                   aligned: bool = True, out_aligned: bool = True
                   ) -> AdmitGeometry:
    """The launch geometry for an (n_cap, Q) plane with Wb/Wd-word label
    rows on a card with ``sms`` SMs.  ``aligned``: the four label planes'
    bases are 16-byte aligned (vector loads); ``out_aligned``: the
    output's base is aligned for the packed stores."""
    lanes = lanes_per_thread(q, wb, wd, streamed)
    threads = STREAM_THREADS if streamed else GRID_THREADS
    nw = 2 * wb + wd
    groups = -(-q // lanes)
    span = min(groups, threads,
               max(1, LANE_SMEM_BYTES // (max(1, nw) * lanes * 4)))
    rows = threads // span
    slabs = -(-groups // span)
    pack = q % lanes == 0 and out_aligned
    lane_bytes = nw * span * lanes * 4      # the staged lane side
    if streamed:
        nb = pick_n_block(n_cap, sms, wb, wd, lane_bytes) \
            if n_block is None else n_block
        blocks = min(-(-n_cap // nb) * slabs, sms)
        smem = lane_bytes + 2 * nb * nw * 4
        return AdmitGeometry(threads, lanes, groups, span, rows, slabs,
                             blocks, nb, pack, aligned, smem)
    blocks = min(-(-n_cap // rows), sms * GRID_BLOCKS_PER_SM)
    return AdmitGeometry(threads, lanes, groups, span, rows, slabs, blocks,
                         0, pack, aligned, lane_bytes)


def admit_coverage(g: AdmitGeometry, n_cap: int) -> np.ndarray:
    """(n_cap, groups) int64: how many times the kernel's (block, thread,
    lane group, row) mapping writes each row's lane group, by the same
    index arithmetic as the sources (see ``AdmitGeometry``).  Every entry
    is 1 for a geometry that covers the plane exactly once."""
    t = np.arange(g.threads)
    off, gl = t // g.span, t % g.span
    idx = []
    if g.n_block:
        nchunks = -(-n_cap // g.n_block)
        for b in range(g.blocks):
            for it in range(b, nchunks * g.slabs, g.blocks):
                grp = (it // nchunks) * g.span + gl
                on = (off < g.rows) & (grp < g.groups)
                x0 = (it % nchunks) * g.n_block
                nx = min(g.n_block, n_cap - x0)
                xl = off[on][:, None] + g.rows * np.arange(
                    -(-g.n_block // g.rows))[None, :]
                ok = xl < nx
                gg = np.broadcast_to(grp[on][:, None], xl.shape)
                idx.append((x0 + xl[ok]) * g.groups + gg[ok])
    else:
        step = g.blocks * g.rows
        for slab in range(g.slabs):
            grp = slab * g.span + gl
            on = (off < g.rows) & (grp < g.groups)
            x = (np.arange(g.blocks)[:, None] * g.rows
                 + off[on][None, :]).ravel()
            gg = np.tile(grp[on], g.blocks)
            for k in range(-(-n_cap // step)):
                xs = x + k * step
                ok = xs < n_cap
                idx.append(xs[ok] * g.groups + gg[ok])
    flat = np.concatenate(idx) if idx else np.zeros(0, np.int64)
    return np.bincount(flat, minlength=n_cap * g.groups).reshape(
        n_cap, g.groups)


def admit_plain(bl_in, bl_out, dl_in, dl_out, u, v, m_cut=None,
                m_total=None, d_cut=None, d_total=None) -> torch.Tensor:
    """The kernel's function in PyTorch ops: the core admit plane
    ``core.query._admit_plane`` with the DL term gated by the cutoffs (twin
    of the reference's ``ref.py::admit_ref``).  Ids are clamped into
    ``[0, n_cap)``.  -> (n_cap, Q) int8."""
    dl_on = None
    if m_cut is not None:
        dl_on = m_cut >= m_total
        if d_cut is not None:
            dl_on = dl_on & (d_cut >= d_total)
    p = Q.PackedLabels(dl_in, dl_out, bl_in, bl_out)
    return Q._admit_plane(p, u, v, bl_in.shape[0], dl_on).to(torch.int8)


def _check_planes(bl_in, bl_out, dl_in, dl_out, u, v, dev):
    n_cap, wb = bl_in.shape
    wd = dl_in.shape[1]
    q = u.shape[0]
    _check("bl_in", bl_in, dev)
    _check("bl_out", bl_out, dev, (n_cap, wb))
    _check("dl_in", dl_in, dev, (n_cap, wd))
    _check("dl_out", dl_out, dev, (n_cap, wd))
    _check("u", u, dev, (q,))
    _check("v", v, dev, (q,))
    return n_cap, wb, wd, q


def _fresh_row(m_cut, m_total, d_cut, d_total):
    """The admit kernels' one freshness row: ``(m_cut >= m_total) & (d_cut
    >= d_total)`` as (Q,) int32 0/1, or None without cutoffs."""
    _check_pairs(m_cut, m_total, d_cut, d_total)
    if m_cut is None:
        return None
    fresh = m_cut >= m_total
    if d_cut is not None:
        fresh = fresh & (d_cut >= d_total)
    return fresh.to(torch.int32)


def _admit_fake(bl_in, bl_out, dl_in, dl_out, u, v, fresh, *rest):
    return u.new_empty((bl_in.shape[0], u.shape[0]), dtype=torch.int8)


def _admit_cpu(bl_in, bl_out, dl_in, dl_out, u, v, fresh):
    return admit_plain(bl_in, bl_out, dl_in, dl_out, u, v, fresh,
                       None if fresh is None else 1)


def _admit_cuda(bl_in, bl_out, dl_in, dl_out, u, v, fresh):
    """The grid kernel on CUDA tensors; the freshness row is passed as an
    edge-count cutoff with total 1."""
    dev = u.device
    n_cap, wb, wd, q = _check_planes(bl_in, bl_out, dl_in, dl_out, u, v, dev)
    if fresh is not None:
        _check("fresh", fresh, dev, (q,))
    out = torch.empty((n_cap, q), dtype=torch.int8, device=dev)
    if q == 0 or n_cap == 0:
        return out
    g = admit_geometry(n_cap, q, wb, wd, _build.sm_count(dev),
                       aligned=_aligned(bl_in, bl_out, dl_in, dl_out),
                       out_aligned=_aligned(out))
    lib = _build.load("bfs_prune")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    p = _build.ptr
    with torch.cuda.device(dev):
        err = lib.bfs_admit_plane(
            p(bl_in), p(bl_out), wb, p(dl_in), p(dl_out), wd, n_cap, p(u),
            p(v), q, p(fresh), int(fresh is not None), p(None), 0, p(out),
            g.lanes, g.groups, g.span, g.rows, g.slabs, int(g.pack),
            int(g.vec), g.threads, g.blocks, g.smem, stream)
    _build.check(lib, err, "admit_kernel")
    bfs_admit_plane.launches += 1
    return out


admit_op = _build.register_op(
    "bfs_admit_plane",
    "(Tensor bl_in, Tensor bl_out, Tensor dl_in, Tensor dl_out, Tensor u, "
    "Tensor v, Tensor? fresh) -> Tensor", _admit_cpu, _admit_cuda,
    _admit_fake)


def bfs_admit_plane(bl_in, bl_out, dl_in, dl_out, u, v, m_cut=None,
                    m_total=None, d_cut=None, d_total=None) -> torch.Tensor:
    """(n_cap, Q) int8 admit plane.

    Planes (n_cap, W) int32 row-major; ``u``/``v`` (Q,) int32 (ids are
    clamped, so a dead lane ``u = n_cap`` reads the last row).  Optional
    ``m_cut`` (Q,) int32 with ``m_total`` and ``d_cut`` (Q,) int32 with
    ``d_total`` (needs the m-cut pair; totals ints or 0-d tensors) gate
    the DL term per lane; they are pre-combined into one freshness row and
    handed to the grid kernel ``csrc/bfs_prune.cu`` (the op ``admit_op``,
    the plain version on CPU tensors).
    """
    return admit_op(bl_in, bl_out, dl_in, dl_out, u, v,
                    _fresh_row(m_cut, m_total, d_cut, d_total))


bfs_admit_plane.launches = 0


# ------------------------------------------------- streamed (double-buffered)
def admit_streamed_plain(bl_in, bl_out, dl_in, dl_out, u, v, fresh=None
                         ) -> torch.Tensor:
    """The streamed kernel's function in PyTorch ops: the core admit plane
    ``core.query._admit_plane`` with the DL term gated by the one
    pre-combined 0/1 freshness row ``fresh`` (Q,) (twin of the reference's
    ``bfs_admit_plane_streamed``).  -> (n_cap, Q) int8."""
    p = Q.PackedLabels(dl_in, dl_out, bl_in, bl_out)
    dl_on = None if fresh is None else fresh != 0
    return Q._admit_plane(p, u, v, bl_in.shape[0], dl_on).to(torch.int8)


def _streamed_cpu(bl_in, bl_out, dl_in, dl_out, u, v, fresh, n_block):
    return admit_streamed_plain(bl_in, bl_out, dl_in, dl_out, u, v, fresh)


def _streamed_cuda(bl_in, bl_out, dl_in, dl_out, u, v, fresh, n_block):
    dev = u.device
    n_cap, wb, wd, q = _check_planes(bl_in, bl_out, dl_in, dl_out, u, v, dev)
    if fresh is not None:
        _check("fresh", fresh, dev, (q,))
    out = torch.empty((n_cap, q), dtype=torch.int8, device=dev)
    if q == 0 or n_cap == 0:
        return out
    g = admit_geometry(n_cap, q, wb, wd, _build.sm_count(dev), streamed=True,
                       n_block=n_block,
                       aligned=_aligned(bl_in, bl_out, dl_in, dl_out),
                       out_aligned=_aligned(out))
    if g.smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"n_block={g.n_block} with {2 * wb + wd} label "
                         f"words a row needs {g.smem} bytes of shared "
                         "memory per block (lane side and ring), above the "
                         f"card's {_build.MAX_SMEM_BYTES}; use a smaller "
                         "n_block")
    lib = _build.load("bfs_prune_streamed")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    p = _build.ptr
    with torch.cuda.device(dev):
        err = lib.bfs_admit_plane_streamed(
            p(bl_in), p(bl_out), wb, p(dl_in), p(dl_out), wd, n_cap, p(u),
            p(v), q, p(fresh), p(out), g.lanes, g.groups, g.span, g.rows,
            g.slabs, g.n_block, int(g.pack), int(g.vec), g.threads,
            g.blocks, g.smem, stream)
    _build.check(lib, err, "streamed_admit_kernel")
    bfs_admit_plane_streamed.launches += 1
    return out


streamed_admit_op = _build.register_op(
    "bfs_admit_plane_streamed",
    "(Tensor bl_in, Tensor bl_out, Tensor dl_in, Tensor dl_out, Tensor u, "
    "Tensor v, Tensor? fresh, int? n_block) -> Tensor", _streamed_cpu,
    _streamed_cuda, _admit_fake)


def bfs_admit_plane_streamed(bl_in, bl_out, dl_in, dl_out, u, v, m_cut=None,
                             m_total=None, d_cut=None, d_total=None, *,
                             n_block: int | None = None) -> torch.Tensor:
    """(n_cap, Q) int8 admit plane, the same as ``bfs_admit_plane``,
    through the streamed kernel: the cutoffs are pre-combined into one
    freshness row, ``(m_cut >= m_total) & (d_cut >= d_total)``, and handed
    to ``streamed_admit_row``."""
    return streamed_admit_row(bl_in, bl_out, dl_in, dl_out, u, v,
                              _fresh_row(m_cut, m_total, d_cut, d_total),
                              n_block=n_block)


def streamed_admit_row(bl_in, bl_out, dl_in, dl_out, u, v, fresh=None, *,
                       n_block: int | None = None) -> torch.Tensor:
    """The streamed kernel ``csrc/bfs_prune_streamed.cu`` (the op
    ``streamed_admit_op``) on the pre-combined freshness row ``fresh``
    (Q,) int32 0/1 or None (persistent blocks, each thread's lanes
    resident in registers, the vertex axis streamed in ``n_block``-row
    chunks through a two-stage shared-memory ring filled by
    ``cp.async``).  ``n_block`` (a multiple of 4) defaults to
    ``pick_n_block``.  A block's staged lane side takes at most
    ``LANE_SMEM_BYTES`` (more lanes spread over lane slabs), so any number
    of lanes fits; only an ``n_block`` whose ring does not fit beside it
    at these label widths raises.  CPU tensors take
    ``admit_streamed_plain``.  ``bfs_admit_plane_streamed.launches``
    counts kernel launches."""
    if n_block is not None and (n_block <= 0 or n_block % 4):
        raise ValueError(f"n_block must be a positive multiple of 4, "
                         f"got {n_block}")
    return streamed_admit_op(bl_in, bl_out, dl_in, dl_out, u, v, fresh,
                             n_block)


bfs_admit_plane_streamed.launches = 0
