"""Wrapper from packed labels + query ids to the (n_cap, Qc) admit plane."""
from __future__ import annotations

import torch

from repro_torch.core.query import PackedLabels, il_violation_plane
from repro_torch.device import resolve_device
from .bfs_prune import bfs_admit_plane, bfs_admit_plane_streamed


def admit_plane(p: PackedLabels, u, v, m_cut=None, m_total=None,
                d_cut=None, d_total=None, il=None, il_on=None, *,
                out_dtype=torch.bool, device=None,
                streaming: bool = False) -> torch.Tensor:
    """(n_cap, Qc) ``out_dtype`` admit plane for the pruned-BFS lanes: the
    kernel for CUDA labels, its plain version for CPU labels.
    ``streaming=True`` routes to the streamed kernel.

    ``m_cut``/``d_cut`` (Qc,) with their totals (ints or 0-d tensors) gate
    the DL prune per lane.
    ``il`` = (il_in, il_out) ANDs the interval containment prune around the
    kernel's output; ``il_on`` (bool or (Qc,)) gates it.  ``device``
    (default ``"cuda"``) must be where the labels live."""
    dev = resolve_device(device)
    if p.dl_in.device.type != dev.type:
        raise ValueError(f"labels live on {p.dl_in.device}, not {dev}")
    dev = p.dl_in.device

    def i32(t):
        return None if t is None else torch.as_tensor(
            t, dtype=torch.int32, device=dev).contiguous()

    u, v = i32(u), i32(v)
    args = (p.bl_in, p.bl_out, p.dl_in, p.dl_out, u, v, i32(m_cut),
            m_total, i32(d_cut), d_total)
    if streaming:
        out = bfs_admit_plane_streamed(*args)
    else:
        out = bfs_admit_plane(*args)
    if il is not None:
        bad = il_violation_plane(il, v)
        if il_on is not None:
            bad = bad & torch.as_tensor(il_on, device=dev).expand(
                u.shape[0])[None, :]
        out = (out > 0) & ~bad
    return out.to(out_dtype)
