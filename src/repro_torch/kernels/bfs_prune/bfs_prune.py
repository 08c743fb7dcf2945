"""BFS admit plane: the CUDA kernel ``csrc/bfs_prune.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/bfs_prune/bfs_prune.py``
``bfs_admit_plane`` (body ``_make_kernel``, line 41):

    admit[x, q] = BL_in(x) ⊆ BL_in(v_q) ∧ BL_out(v_q) ⊆ BL_out(x)
                  ∧ ¬(DL_out(u_q) ∩ DL_in(x) ≠ ∅)

with the DL term gated off for lanes whose edge-count cutoff
(``m_cut < m_total``) or tombstone cutoff (``d_cut < d_total``) is stale.
Output (n_cap, Q) int8.  At the serving shapes the kernel is bound by its
integer operations (a few per output byte), at small Q by bytes (the n*Q
output plus one read of three vertex planes); each block stages one vertex
tile and every lane's query-side words in shared memory and writes a
contiguous span of the output.

``bfs_admit_plane`` launches the kernel for CUDA tensors and takes
``admit_plain`` for CPU tensors.  ``bfs_admit_plane.launches`` counts
kernel launches.

The streamed kernel ``csrc/bfs_prune_streamed.cu`` replaces
``bfs_admit_plane_streamed`` (body ``_make_streamed_kernel``, line 135):
the same plane with the vertex axis streamed in chunks and the cutoffs
pre-combined into one freshness row.  ``bfs_admit_plane_streamed`` and
``admit_streamed_plain`` are its wrapper and plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import query as Q
from repro_torch.kernels import _build
from repro_torch.kernels.dbl_query.dbl_query import _check, freshness_rows


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


def bfs_admit_plane(bl_in, bl_out, dl_in, dl_out, u, v, m_cut=None,
                    m_total=None, d_cut=None, d_total=None) -> torch.Tensor:
    """(n_cap, Q) int8 admit plane.

    Planes (n_cap, W) int32 row-major; ``u``/``v`` (Q,) int32 (ids are
    clamped, so a dead lane ``u = n_cap`` reads the last row).  Optional
    ``m_cut`` (Q,) int32 with ``m_total`` int and ``d_cut`` (Q,) int32
    with ``d_total`` int (needs the m-cut pair) gate the DL term per lane.
    """
    if (m_cut is None) != (m_total is None) or \
            (d_cut is None) != (d_total is None):
        raise ValueError("pass each cutoff with its total")
    if d_cut is not None and m_cut is None:
        raise ValueError("the tombstone cutoff needs the edge-count cutoff")
    if u.device.type == "cpu":
        return admit_plain(bl_in, bl_out, dl_in, dl_out, u, v, m_cut,
                           m_total, d_cut, d_total)
    if u.device.type != "cuda":
        raise ValueError(f"no kernel for device {u.device}")
    dev = u.device
    n_cap, wb = bl_in.shape
    wd = dl_in.shape[1]
    q = u.shape[0]
    _check("bl_in", bl_in, dev)
    _check("bl_out", bl_out, dev, (n_cap, wb))
    _check("dl_in", dl_in, dev, (n_cap, wd))
    _check("dl_out", dl_out, dev, (n_cap, wd))
    _check("u", u, dev, (q,))
    _check("v", v, dev, (q,))
    for name, t in (("m_cut", m_cut), ("d_cut", d_cut)):
        if t is not None:
            _check(name, t, dev, (q,))
    out = torch.empty((n_cap, q), dtype=torch.int8, device=dev)
    if q == 0 or n_cap == 0:
        return out
    lib = _build.load("bfs_prune")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    p = _build.ptr
    with torch.cuda.device(dev):
        err = lib.bfs_admit_plane(
            p(bl_in), p(bl_out), wb, p(dl_in), p(dl_out), wd, n_cap, p(u),
            p(v), q, p(m_cut), int(m_total or 0), p(d_cut),
            int(d_total or 0), p(out), stream)
    _build.check(lib, err, "admit_kernel")
    bfs_admit_plane.launches += 1
    return out


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


def pick_n_block(n_cap: int, sms: int) -> int:
    """Rows per streamed chunk: a power of two in [32, 1024] that gives each
    of about ``sms`` persistent blocks four chunks or more to walk."""
    nb = 32
    while nb < 1024 and nb * 2 * 4 * sms <= n_cap:
        nb *= 2
    return nb


def bfs_admit_plane_streamed(bl_in, bl_out, dl_in, dl_out, u, v, m_cut=None,
                             m_total=None, d_cut=None, d_total=None, *,
                             n_block: int | None = None) -> torch.Tensor:
    """(n_cap, Q) int8 admit plane, the same as ``bfs_admit_plane``,
    through the streamed kernel: the cutoffs are pre-combined into one
    freshness row, ``(m_cut >= m_total) & (d_cut >= d_total)``, and handed
    to ``streamed_admit_row``."""
    cut = freshness_rows(m_cut, m_total, d_cut, d_total)
    fresh = None if cut is None else cut.all(0).to(torch.int32)
    return streamed_admit_row(bl_in, bl_out, dl_in, dl_out, u, v, fresh,
                              n_block=n_block)


def streamed_admit_row(bl_in, bl_out, dl_in, dl_out, u, v, fresh=None, *,
                       n_block: int | None = None) -> torch.Tensor:
    """The streamed kernel ``csrc/bfs_prune_streamed.cu`` on the
    pre-combined freshness row ``fresh`` (Q,) int32 0/1 or None
    (persistent blocks, the lane side resident in shared memory, the
    vertex axis streamed in ``n_block``-row chunks through a two-stage
    cp.async ring).  ``n_block`` (a multiple of 4) defaults to
    ``pick_n_block``; a Q whose lane side and ring do not fit in shared
    memory raises.  CPU tensors take ``admit_streamed_plain``.
    ``bfs_admit_plane_streamed.launches`` counts kernel launches."""
    if n_block is not None and (n_block <= 0 or n_block % 4):
        raise ValueError(f"n_block must be a positive multiple of 4, "
                         f"got {n_block}")
    if u.device.type == "cpu":
        return admit_streamed_plain(bl_in, bl_out, dl_in, dl_out, u, v,
                                    fresh)
    if u.device.type != "cuda":
        raise ValueError(f"no kernel for device {u.device}")
    dev = u.device
    n_cap, wb = bl_in.shape
    wd = dl_in.shape[1]
    q = u.shape[0]
    _check("bl_in", bl_in, dev)
    _check("bl_out", bl_out, dev, (n_cap, wb))
    _check("dl_in", dl_in, dev, (n_cap, wd))
    _check("dl_out", dl_out, dev, (n_cap, wd))
    _check("u", u, dev, (q,))
    _check("v", v, dev, (q,))
    if fresh is not None:
        _check("fresh", fresh, dev, (q,))
    out = torch.empty((n_cap, q), dtype=torch.int8, device=dev)
    if q == 0 or n_cap == 0:
        return out
    sms = _build.sm_count(dev)
    nb = pick_n_block(n_cap, sms) if n_block is None else n_block
    lib = _build.load("bfs_prune_streamed")
    smem = lib.bfs_prune_streamed_smem_bytes(wb, wd, q, nb)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"Q={q} lanes with n_block={nb} need {smem} bytes "
                         "of shared memory per block, above the card's "
                         f"{_build.MAX_SMEM_BYTES}; use fewer lanes or a "
                         "smaller n_block")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    p = _build.ptr
    with torch.cuda.device(dev):
        err = lib.bfs_admit_plane_streamed(
            p(bl_in), p(bl_out), wb, p(dl_in), p(dl_out), wd, n_cap, p(u),
            p(v), q, p(fresh), nb, p(out), sms, stream)
    _build.check(lib, err, "streamed_admit_kernel")
    bfs_admit_plane_streamed.launches += 1
    return out


bfs_admit_plane_streamed.launches = 0
