"""Label-plane pack: the CUDA kernel ``csrc/pack_planes.cu`` and its
plain PyTorch version.

``pack_planes_kernel`` packs the four 0/1 label planes of an index
(DL_in, DL_out (n, k); BL_in, BL_out (n, k')) into (n, ceil(k/32)) and
(n, ceil(k'/32)) int32 words, the layout of ``core.bitset.pack``, in one
launch.  It replaces no TPU kernel: on the TPU the pack was left to XLA,
and the port's plain pack widens every byte to int64.  It is bound by
bytes (each plane byte read once, each word written once); the source
says how its loads reach that.

``pack_label_planes`` goes through the torch custom op
``repro_torch::pack_label_planes`` (``pack_op``), registered when this
module is imported (``_build.register_op``): the CUDA implementation
checks the planes and launches the kernel once for all four, the CPU one
is ``bitset.pack`` of each plane (``pack_plain``), and the fake one gives
the four word shapes, so that ``torch.export`` traces through it.
``pack_label_planes.launches`` counts kernel launches.  ``plane_mode``
picks a plane's loads as the kernel reads them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitset
from repro_torch.kernels import _build

#: how the kernel reads a plane's words (``Mode`` in the source): bytes,
#: or 8-byte loads (k % 8 == 0, base 8-byte aligned)
BYTES, VEC8 = 0, 1
PLANE_DTYPES = (torch.bool, torch.uint8)
_NAMES = ("dl_in", "dl_out", "bl_in", "bl_out")


def plane_mode(k: int, address: int) -> int:
    """The loads the kernel takes for a plane of width ``k`` whose first
    byte is at ``address``."""
    return VEC8 if k % 8 == 0 and address % 8 == 0 else BYTES


def pack_plain(dl_in, dl_out, bl_in, bl_out) -> tuple:
    """The kernel's function in PyTorch ops: ``bitset.pack`` of each
    plane."""
    return tuple(bitset.pack(p) for p in (dl_in, dl_out, bl_in, bl_out))


# -------------------------------------------------------------- the op
_SCHEMA = ("(Tensor dl_in, Tensor dl_out, Tensor bl_in, Tensor bl_out) "
           "-> (Tensor, Tensor, Tensor, Tensor)")


def _words_like(planes):
    return tuple(p.new_empty((p.shape[0], bitset.n_words(p.shape[1])),
                             dtype=torch.int32) for p in planes)


def _pack_cuda(dl_in, dl_out, bl_in, bl_out):
    """The kernel on CUDA planes: contiguous (n, k) bool or uint8 on one
    device; raises on anything else."""
    planes = (dl_in, dl_out, bl_in, bl_out)
    dev = dl_in.device
    for name, x in zip(_NAMES, planes):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, dl_in on {dev}: "
                             "the four planes must share a device")
        if x.dtype not in PLANE_DTYPES or x.dim() != 2 or \
                not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-d bool or "
                             f"uint8 plane, got {x.dtype} of shape "
                             f"{tuple(x.shape)}, strides {x.stride()}")
    n, k = dl_in.shape
    kb = bl_in.shape[1]
    for name, x, want in zip(_NAMES[1:], planes[1:],
                             ((n, k), (n, kb), (n, kb))):
        if tuple(x.shape) != want:
            raise ValueError(f"{name} must have shape {want}, "
                             f"got {tuple(x.shape)}")
    outs = _words_like(planes)
    if n * (bitset.n_words(k) + bitset.n_words(kb)) == 0:
        return outs
    lib = _build.load("pack_planes")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    p = _build.ptr
    with torch.cuda.device(dev):
        err = lib.pack_label_planes(
            *(p(x) for x in planes), *(p(o) for o in outs), n, k, kb,
            *(plane_mode(x.shape[1], x.data_ptr()) for x in planes), stream)
    _build.check(lib, err, "pack_planes_kernel")
    pack_label_planes.launches += 1
    return outs


def _pack_fake(dl_in, dl_out, bl_in, bl_out):
    return _words_like((dl_in, dl_out, bl_in, bl_out))


pack_op = _build.register_op("pack_label_planes", _SCHEMA, pack_plain,
                             _pack_cuda, _pack_fake)


def pack_label_planes(dl_in, dl_out, bl_in, bl_out) -> tuple:
    """(dl_in, dl_out, bl_in, bl_out) int32 words of the four 0/1 planes,
    each equal to ``bitset.pack`` of its plane: one launch of
    ``csrc/pack_planes.cu`` for CUDA planes (the op ``pack_op``), the plain
    pack for CPU planes.  Fresh outputs on every call."""
    return pack_op(dl_in, dl_out, bl_in, bl_out)


pack_label_planes.launches = 0
