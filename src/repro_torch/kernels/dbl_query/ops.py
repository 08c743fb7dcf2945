"""Wrappers from packed labels + query ids to the verdict kernel."""
from __future__ import annotations

import torch

from repro_torch.core.query import PackedLabels
from repro_torch.device import resolve_device
from .dbl_query import dbl_query_verdicts


def _on(t, dev):
    if t is None or t.device == dev:
        return t
    raise ValueError(f"tensor on {t.device}, expected {dev}")


def verdicts_device(p: PackedLabels, u: torch.Tensor, v: torch.Tensor,
                    m_cut: torch.Tensor | None = None, m_total=None,
                    d_cut: torch.Tensor | None = None, d_total=None,
                    il=None, *, out_dtype=torch.int32) -> torch.Tensor:
    """(Q,) verdicts on the planes' device: the kernel for CUDA tensors,
    its plain version for CPU tensors.  ``m_cut``/``d_cut`` (Q,) with their
    totals thread the edge-count and tombstone cutoffs; ``il`` is the
    optional ``(il_in, il_out)`` interval operand."""
    dev = p.dl_in.device
    i32 = torch.int32
    il_in, il_out = (None, None) if il is None else il
    return dbl_query_verdicts(
        p.dl_in, p.dl_out, p.bl_in, p.bl_out,
        _on(u, dev).to(i32).contiguous(), _on(v, dev).to(i32).contiguous(),
        None if m_cut is None else _on(m_cut, dev).to(i32).contiguous(),
        None if m_total is None else int(m_total),
        None if d_cut is None else _on(d_cut, dev).to(i32).contiguous(),
        None if d_total is None else int(d_total),
        il_in, il_out, out_dtype=out_dtype)


def query_verdicts(p: PackedLabels, u, v, il=None, *, device=None
                   ) -> torch.Tensor:
    """(Q,) int32 verdicts; same contract as ``core.query.label_verdicts``.
    ``device`` (default ``"cuda"``) must be where the labels live."""
    dev = resolve_device(device)
    if p.dl_in.device.type != dev.type:
        raise ValueError(f"labels live on {p.dl_in.device}, not {dev}")
    u = torch.as_tensor(u, dtype=torch.int32, device=p.dl_in.device)
    v = torch.as_tensor(v, dtype=torch.int32, device=p.dl_in.device)
    return verdicts_device(p, u, v, il=il)
