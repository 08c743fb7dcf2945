"""Fused DBL label verdict: the CUDA kernels ``csrc/dbl_query.cu`` and
``csrc/dbl_query_streamed.cu``, their plain PyTorch versions and their
launch geometry.

``verdicts_kernel`` replaces the TPU kernel
``src/repro/kernels/dbl_query/dbl_query.py`` ``dbl_query_verdicts`` (body
``_make_kernel``, line 35).  It takes the four packed planes (n_cap, W)
int32 and the query ids and writes one verdict per lane: +1 reachable, 0
unreachable, -1 unknown.  ``streamed_verdicts_kernel`` replaces
``dbl_query_verdicts_streamed`` (body ``_make_streamed_kernel``, line
174): the same verdicts without interval planes, persistent blocks walking
chunks of the query axis, the cutoffs pre-combined into freshness rows.

Both kernels are built on one tile (``csrc/verdict_tile.cuh``): one
thread a lane loads the lane's ids and cutoffs, then all eight label rows
at once (whole rows, compile-time widths W = 1..4 with vector loads where
the planes are aligned, or a run-time-width instance), and folds them
into one accumulator per test.  They are bound by bytes (ids, eight
gathered rows and the verdict per lane); at a serving batch the rows sit
in L2 and the time is the launch and two dependent round trips.
``verdict_geometry`` picks the launch (blocks, threads) and the compiled
instance; ``verdict_coverage`` mirrors the kernels' index
arithmetic for the CPU tests.

Each kernel is a torch custom op, ``repro_torch::dbl_query_verdicts`` and
``repro_torch::dbl_query_verdicts_streamed`` (``verdicts_op``,
``streamed_verdicts_op``), registered when this module is imported
(``_build.register_op``): the
CUDA implementation launches the kernel, the CPU one is the plain version
(``verdicts_plain`` / ``verdicts_streamed_plain``), and a fake
implementation gives the output's shape and dtype, so that
``torch.export`` traces a phase through the kernel as one graph node and a
loaded program reaches the same kernel.  The ops take the cutoffs as
pre-combined 0/1 freshness rows (``freshness_rows``), never as host
integers, which export would bake into the graph.  ``dbl_query_verdicts``
and ``streamed_verdicts_rows`` are the wrappers;
``dbl_query_verdicts.launches`` and ``dbl_query_verdicts_streamed.launches``
count kernel launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import query as Q
from repro_torch.kernels import _build

#: threads per block of the grid kernel, one lane a thread: the fastest of
#: 64 to 1 024 threads, and of two threads a lane, at the LJ label batch
#: on an H100 (PERF.md)
GRID_THREADS = 64
#: the streamed kernel's largest chunk (lanes = threads per block, the
#: sources' __launch_bounds__ cap)
MAX_CHUNK = 256


@dataclass(frozen=True)
class VerdictGeometry:
    """Launch of a verdict kernel, one lane a thread.  Thread ``t`` of
    block ``b`` takes lane ``threads * b + t`` (the grid kernel) or lanes
    ``threads * (b + j * blocks) + t`` for j = 0, 1, ... below Q (the
    streamed kernel's persistent walk over chunks of ``threads`` lanes).
    ``instance`` is the compiled rows instance ``(W_dl, W_bl, vec)``, or
    None for the run-time widths."""
    blocks: int
    threads: int
    instance: tuple[int, int, bool] | None


def verdict_geometry(q: int, wd: int, wb: int, sms: int, streamed: bool,
                     aligned: bool) -> VerdictGeometry:
    """The launch for Q lanes of W_dl/W_bl-word label rows on a card with
    ``sms`` SMs.  The grid kernel takes ``GRID_THREADS``-thread blocks.
    The streamed kernel takes at most one block per SM, each walking
    chunks of ``threads`` lanes: the chunk spreads Q over the SMs (a
    multiple of 32, at most ``MAX_CHUNK``), so that no block walks two
    chunks while Q fits one wave.  ``aligned``: the four planes' bases
    are 16-byte aligned.  The instance is one the sources compile
    (``verdict::dispatch`` in ``csrc/verdict_tile.cuh``): compile-time
    widths for W in 1..4, with vector row loads where the planes are
    aligned and a width is 2 or 4 (a 3-word row is not 8-byte aligned at
    odd rows); None, the run-time widths, beyond."""
    inst = None
    if 1 <= wd <= 4 and 1 <= wb <= 4:
        inst = wd, wb, aligned and (wd in (2, 4) or wb in (2, 4))
    if not streamed:
        return VerdictGeometry(-(-q // GRID_THREADS), GRID_THREADS, inst)
    per_sm = -(-q // sms)
    chunk = min(MAX_CHUNK, max(32, -(-per_sm // 32) * 32))
    return VerdictGeometry(min(sms, -(-q // chunk)), chunk, inst)


def verdict_coverage(g: VerdictGeometry, q: int) -> np.ndarray:
    """(blocks, Q) int64: how many times each block writes each lane, by
    the kernels' index arithmetic (see ``VerdictGeometry``).  Every
    column sums to 1 for a geometry that covers Q exactly once; a row's
    sum over ``threads`` (rounded up) is the number of chunks its block
    computes in series."""
    out = np.zeros((g.blocks, q), np.int64)
    for b in range(g.blocks):
        for c0 in range(b * g.threads, q, g.blocks * g.threads):
            out[b, c0:c0 + g.threads] += 1
    return out


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _vec(g: VerdictGeometry) -> bool:
    return g.instance is not None and g.instance[2]


def verdicts_plain(dl_in, dl_out, bl_in, bl_out, u, v,
                   m_cut=None, m_total=None, d_cut=None, d_total=None,
                   il_in=None, il_out=None, out_dtype=torch.int32
                   ) -> torch.Tensor:
    """The kernel's function in PyTorch ops: the core algebra
    ``core.query.cut_verdicts_rows`` over clamped row gathers (twin of the
    reference's ``ref.py::verdict_ref``, with the interval planes folded
    in).  ``same`` compares the raw ids."""
    p = Q.PackedLabels(dl_in, dl_out, bl_in, bl_out)
    il = None if il_in is None else (il_in, il_out)
    d_fresh = True if d_cut is None else d_cut >= d_total
    verd = Q.cut_verdicts_rows(
        Q.gather_rows(p, u, v), u, v, 1 if m_cut is None else m_cut,
        0 if m_total is None else m_total, d_fresh,
        il_rows=Q.gather_il_rows(il, u, v))
    return verd.to(out_dtype)


def _check(name, t, device, shape=None):
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def _check_pairs(m_cut, m_total, d_cut, d_total):
    if (m_cut is None) != (m_total is None) or \
            (d_cut is None) != (d_total is None):
        raise ValueError("pass each cutoff with its total")
    if d_cut is not None and m_cut is None:
        raise ValueError("the tombstone cutoff needs the edge-count cutoff")


def _out_dtype(out_int8: bool) -> torch.dtype:
    return torch.int8 if out_int8 else torch.int32


def _check_out_dtype(out_dtype):
    if out_dtype not in (torch.int8, torch.int32):
        raise ValueError(f"out_dtype must be int8 or int32, got {out_dtype}")


def _cut_totals(cut):
    """(m_cut, m_total, d_cut, d_total) of pre-combined freshness rows
    ``cut`` (ncut, Q) or None: each row is a cutoff whose total is 1, so a
    lane is fresh exactly where its row holds 1."""
    if cut is None:
        return None, None, None, None
    return (cut[0], 1) + ((cut[1], 1) if cut.shape[0] > 1 else (None, None))


def _check_cut(cut):
    if cut is not None and cut.shape[0] not in (1, 2):
        raise ValueError(f"cut must hold 1 or 2 freshness rows, got "
                         f"{cut.shape[0]}")


# ------------------------------------------------------- the custom ops
_VERDICTS_SCHEMA = ("(Tensor dl_in, Tensor dl_out, Tensor bl_in, "
                    "Tensor bl_out, Tensor u, Tensor v, Tensor? cut, "
                    "Tensor? il_in, Tensor? il_out, bool out_int8) -> Tensor")
_STREAMED_SCHEMA = ("(Tensor dl_in, Tensor dl_out, Tensor bl_in, "
                    "Tensor bl_out, Tensor u, Tensor v, Tensor? cut, "
                    "bool out_int8) -> Tensor")


def _verdicts_cpu(dl_in, dl_out, bl_in, bl_out, u, v, cut, il_in, il_out,
                  out_int8):
    return verdicts_plain(dl_in, dl_out, bl_in, bl_out, u, v,
                          *_cut_totals(cut), il_in, il_out,
                          _out_dtype(out_int8))


def _verdicts_cuda(dl_in, dl_out, bl_in, bl_out, u, v, cut, il_in, il_out,
                   out_int8):
    """The grid kernel on CUDA tensors; each freshness row is passed as a
    cutoff with total 1."""
    dev = u.device
    n_cap, wd = dl_in.shape
    wb = bl_in.shape[1]
    q = u.shape[0]
    _check("dl_in", dl_in, dev)
    _check("dl_out", dl_out, dev, (n_cap, wd))
    _check("bl_in", bl_in, dev, (n_cap, wb))
    _check("bl_out", bl_out, dev, (n_cap, wb))
    _check("u", u, dev, (q,))
    _check("v", v, dev, (q,))
    if cut is not None:
        _check("cut", cut, dev, (cut.shape[0], q))
    m_cut, m_total, d_cut, d_total = _cut_totals(cut)
    wi = 0
    if il_in is not None:
        wi = il_in.shape[1]
        _check("il_in", il_in, dev, (n_cap, wi))
        _check("il_out", il_out, dev, (n_cap, wi))
    out = torch.empty(q, dtype=_out_dtype(out_int8), device=dev)
    if q == 0:
        return out
    g = verdict_geometry(q, wd, wb, _build.sm_count(dev), streamed=False,
                         aligned=_aligned(dl_in, dl_out, bl_in, bl_out))
    lib = _build.load("dbl_query")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    p = _build.ptr
    with torch.cuda.device(dev):
        err = lib.dbl_query_verdicts(
            p(dl_in), p(dl_out), wd, p(bl_in), p(bl_out), wb, n_cap, p(u),
            p(v), q, p(m_cut), int(m_total or 0), p(d_cut),
            int(d_total or 0), p(il_in), p(il_out), wi, p(out),
            int(out_int8), int(_vec(g)), g.threads, g.blocks, stream)
    _build.check(lib, err, "verdicts_kernel")
    dbl_query_verdicts.launches += 1
    return out


def _verdicts_fake(dl_in, dl_out, bl_in, bl_out, u, v, cut, il_in, il_out,
                   out_int8):
    return u.new_empty(u.shape, dtype=_out_dtype(out_int8))


verdicts_op = _build.register_op("dbl_query_verdicts", _VERDICTS_SCHEMA,
                                 _verdicts_cpu, _verdicts_cuda,
                                 _verdicts_fake)


def dbl_query_verdicts(dl_in, dl_out, bl_in, bl_out, u, v,
                       m_cut=None, m_total=None, d_cut=None, d_total=None,
                       il_in=None, il_out=None, *, out_dtype=torch.int32
                       ) -> torch.Tensor:
    """(Q,) ``out_dtype`` (int8 or int32) verdicts.

    Planes (n_cap, W) int32 row-major; ``u``/``v`` (Q,) int32.  Optional
    ``m_cut`` (Q,) int32 with ``m_total`` (an int or a 0-d tensor): label
    positives on lanes with ``m_cut < m_total`` degrade to unknown.
    Optional ``d_cut`` (Q,) int32 with ``d_total`` (needs the m-cut pair):
    lanes with ``d_cut < d_total`` keep only self-positives and BL
    negatives.  Optional ``il_in``/``il_out`` (n_cap, 2*dim) int32
    interval planes: containment violations join the negatives on d-fresh
    lanes.  The cutoffs are pre-combined into freshness rows
    (``freshness_rows``: row 0 gates label positives, row 1 keeps only
    self-positives and BL negatives where it is 0) and handed to the grid
    kernel ``csrc/dbl_query.cu`` (the op ``verdicts_op``, the plain
    version on CPU tensors).
    """
    _check_out_dtype(out_dtype)
    if (il_in is None) != (il_out is None):
        raise ValueError("pass il_in and il_out together")
    return verdicts_op(dl_in, dl_out, bl_in, bl_out, u, v,
                       freshness_rows(m_cut, m_total, d_cut, d_total),
                       il_in, il_out, out_dtype == torch.int8)


dbl_query_verdicts.launches = 0


# ------------------------------------------------------------- streamed
def freshness_rows(m_cut=None, m_total=None, d_cut=None, d_total=None
                   ) -> torch.Tensor | None:
    """The kernels' pre-combined cutoffs, as the reference's streamed
    wrapper forms them: (ncut, Q) int32 0/1 rows, row 0 = ``m_cut >=
    m_total`` and row 1 = ``d_cut >= d_total``; None when no cutoff is
    given (ncut 0).  The totals may be ints or 0-d tensors."""
    _check_pairs(m_cut, m_total, d_cut, d_total)
    if m_cut is None:
        return None
    if d_cut is None:
        return (m_cut >= m_total).to(torch.int32)[None]
    return torch.stack([m_cut >= m_total, d_cut >= d_total]).to(torch.int32)


def verdicts_streamed_plain(dl_in, dl_out, bl_in, bl_out, u, v, cut=None,
                            out_dtype=torch.int32) -> torch.Tensor:
    """The streamed kernel's function in PyTorch ops: the verdicts of
    ``core.query.cut_verdicts_rows`` over clamped row gathers, gated by the
    pre-combined 0/1 freshness rows ``cut`` (ncut, Q) (twin of the
    reference's ``dbl_query_verdicts_streamed``; no interval planes)."""
    p = Q.PackedLabels(dl_in, dl_out, bl_in, bl_out)
    ncut = 0 if cut is None else cut.shape[0]
    fresh = 1 if ncut == 0 else cut[0]
    d_fresh = True if ncut < 2 else cut[1] != 0
    verd = Q.cut_verdicts_rows(Q.gather_rows(p, u, v), u, v, fresh, 1,
                               d_fresh)
    return verd.to(out_dtype)


def _streamed_cpu(dl_in, dl_out, bl_in, bl_out, u, v, cut, out_int8):
    return verdicts_streamed_plain(dl_in, dl_out, bl_in, bl_out, u, v, cut,
                                   _out_dtype(out_int8))


def _streamed_cuda(dl_in, dl_out, bl_in, bl_out, u, v, cut, out_int8):
    dev = u.device
    n_cap, wd = dl_in.shape
    wb = bl_in.shape[1]
    q = u.shape[0]
    _check("dl_in", dl_in, dev)
    _check("dl_out", dl_out, dev, (n_cap, wd))
    _check("bl_in", bl_in, dev, (n_cap, wb))
    _check("bl_out", bl_out, dev, (n_cap, wb))
    _check("u", u, dev, (q,))
    _check("v", v, dev, (q,))
    ncut = 0
    if cut is not None:
        ncut = cut.shape[0]
        _check("cut", cut, dev, (ncut, q))
    out = torch.empty(q, dtype=_out_dtype(out_int8), device=dev)
    if q == 0:
        return out
    g = verdict_geometry(q, wd, wb, _build.sm_count(dev), streamed=True,
                         aligned=_aligned(dl_in, dl_out, bl_in, bl_out))
    lib = _build.load("dbl_query_streamed")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    p = _build.ptr
    with torch.cuda.device(dev):
        err = lib.dbl_query_verdicts_streamed(
            p(dl_in), p(dl_out), wd, p(bl_in), p(bl_out), wb, n_cap, p(u),
            p(v), q, p(cut), ncut, p(out), int(out_int8), int(_vec(g)),
            g.threads, g.blocks, stream)
    _build.check(lib, err, "streamed_verdicts_kernel")
    dbl_query_verdicts_streamed.launches += 1
    return out


def _streamed_fake(dl_in, dl_out, bl_in, bl_out, u, v, cut, out_int8):
    return u.new_empty(u.shape, dtype=_out_dtype(out_int8))


streamed_verdicts_op = _build.register_op(
    "dbl_query_verdicts_streamed", _STREAMED_SCHEMA, _streamed_cpu,
    _streamed_cuda, _streamed_fake)


def dbl_query_verdicts_streamed(dl_in, dl_out, bl_in, bl_out, u, v,
                                m_cut=None, m_total=None, d_cut=None,
                                d_total=None, *, out_dtype=torch.int32
                                ) -> torch.Tensor:
    """(Q,) ``out_dtype`` verdicts, the same as ``dbl_query_verdicts``
    without interval planes, through the streamed kernel: the cutoffs are
    pre-combined into 0/1 freshness rows (``freshness_rows``) and handed to
    ``streamed_verdicts_rows``."""
    return streamed_verdicts_rows(
        dl_in, dl_out, bl_in, bl_out, u, v,
        freshness_rows(m_cut, m_total, d_cut, d_total), out_dtype=out_dtype)


def streamed_verdicts_rows(dl_in, dl_out, bl_in, bl_out, u, v, cut=None, *,
                           out_dtype=torch.int32) -> torch.Tensor:
    """The streamed kernel ``csrc/dbl_query_streamed.cu`` (the op
    ``streamed_verdicts_op``) on pre-combined freshness rows ``cut``
    (ncut, Q) int32 0/1 or None (persistent blocks walking chunks of the
    query axis, see ``verdict_geometry``).  CPU tensors take
    ``verdicts_streamed_plain``.  ``dbl_query_verdicts_streamed.launches``
    counts kernel launches."""
    _check_out_dtype(out_dtype)
    _check_cut(cut)
    return streamed_verdicts_op(dl_in, dl_out, bl_in, bl_out, u, v, cut,
                                out_dtype == torch.int8)


dbl_query_verdicts_streamed.launches = 0
