"""Wrappers from packed labels + query ids to the verdict kernels."""
from __future__ import annotations

import warnings

import torch

from repro_torch.core.query import PackedLabels
from repro_torch.device import resolve_device
from .dbl_query import dbl_query_verdicts, dbl_query_verdicts_streamed


class StreamILFallbackWarning(UserWarning):
    """A streaming verdict dispatch with interval planes went to the grid
    kernel: the streamed kernel takes no interval operands, and the grid
    kernel's verdicts are the same.  A category of its own, so callers can
    silence or escalate it with the standard ``warnings`` filters."""


def _on(t, dev):
    if t is None or t.device == dev:
        return t
    raise ValueError(f"tensor on {t.device}, expected {dev}")


def verdicts_device(p: PackedLabels, u: torch.Tensor, v: torch.Tensor,
                    m_cut: torch.Tensor | None = None, m_total=None,
                    d_cut: torch.Tensor | None = None, d_total=None,
                    il=None, *, out_dtype=torch.int32,
                    streaming: bool = False) -> torch.Tensor:
    """(Q,) verdicts on the planes' device: the kernel for CUDA tensors,
    its plain version for CPU tensors.  ``m_cut``/``d_cut`` (Q,) with their
    totals (ints or 0-d tensors) thread the edge-count and tombstone
    cutoffs; ``il`` is the
    optional ``(il_in, il_out)`` interval operand.  ``streaming=True``
    routes to the streamed kernel; with ``il`` it warns
    ``StreamILFallbackWarning`` and routes to the grid kernel instead."""
    if streaming and il is not None:
        warnings.warn(
            "the streamed dbl_query kernel takes no interval-family "
            "operands; il-enabled verdict dispatches fall back to the grid "
            "kernel (bitwise-identical verdicts)",
            StreamILFallbackWarning, stacklevel=2)
        streaming = False
    dev = p.dl_in.device
    i32 = torch.int32
    args = (p.dl_in, p.dl_out, p.bl_in, p.bl_out,
            _on(u, dev).to(i32).contiguous(),
            _on(v, dev).to(i32).contiguous(),
            None if m_cut is None else _on(m_cut, dev).to(i32).contiguous(),
            m_total,
            None if d_cut is None else _on(d_cut, dev).to(i32).contiguous(),
            d_total)
    if streaming:
        return dbl_query_verdicts_streamed(*args, out_dtype=out_dtype)
    il_in, il_out = (None, None) if il is None else il
    return dbl_query_verdicts(*args, il_in, il_out, out_dtype=out_dtype)


def query_verdicts(p: PackedLabels, u, v, il=None, *, device=None,
                   streaming: bool = False) -> torch.Tensor:
    """(Q,) int32 verdicts; same contract as ``core.query.label_verdicts``.
    ``device`` (default ``"cuda"``) must be where the labels live."""
    dev = resolve_device(device)
    if p.dl_in.device.type != dev.type:
        raise ValueError(f"labels live on {p.dl_in.device}, not {dev}")
    u = torch.as_tensor(u, dtype=torch.int32, device=p.dl_in.device)
    v = torch.as_tensor(v, dtype=torch.int32, device=p.dl_in.device)
    return verdicts_device(p, u, v, il=il, streaming=streaming)
