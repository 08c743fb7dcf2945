"""Meshes over ``torch.distributed``: one process per mesh position (SPMD).

A :class:`Mesh` names the axes of a process grid, its shape, this rank's
coordinates on it and one process group per axis.  Ranks are laid out
row-major: rank ``r`` sits at ``numpy.unravel_index(r, shape)``, so on a
("data", "model") mesh the model coordinate varies fastest, as a JAX
mesh over ``jax.devices()`` orders them.  ``make_production_mesh``
returns an *abstract* mesh (axis names and shape, no process group): all
the dry run needs, since 256 or 512 ranks cannot run on one card.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """Axis names, shape and, on a live mesh, this rank's coordinates, one
    process group per axis and the device its tensors live on
    (``groups``/``coords``/``device`` are None on an abstract mesh)."""
    axis_names: tuple
    shape: tuple
    coords: tuple | None = None
    device: torch.device | None = None
    groups: dict = field(default_factory=dict, compare=False, repr=False)
    device_mesh: object = field(default=None, compare=False, repr=False)

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def abstract(self) -> bool:
        return self.coords is None

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def get_group(self, axis: str):
        if self.abstract:
            raise ValueError("an abstract mesh has no process groups")
        return self.groups[axis]


def make_mesh_compat(shape, axes, *, device=None) -> Mesh:
    """The mesh of ``shape`` named ``axes`` over the process group the
    caller (or a launcher) has initialized, whose world size must be
    ``prod(shape)``.  The device defaults to ``cuda:<rank % count>`` and
    raises without CUDA; ``device="cpu"`` runs on the CPU (gloo)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh_compat needs an initialized process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "rank=..., world_size=...) in every rank first")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} for axes {axes}")
    world = dist.get_world_size()
    if world != int(np.prod(shape)):
        raise ValueError(f"a {shape} mesh needs {int(np.prod(shape))} "
                         f"ranks; the world has {world}")
    if device is None:
        resolve_device(None)                  # raises without CUDA
        device = f"cuda:{dist.get_rank() % torch.cuda.device_count()}"
    device = resolve_device(device)
    from torch.distributed.device_mesh import DeviceMesh
    dm = DeviceMesh(device.type, np.arange(world).reshape(shape).tolist(),
                    mesh_dim_names=axes)
    coords = tuple(int(c) for c in np.unravel_index(dist.get_rank(), shape))
    return Mesh(axes, shape, coords, device,
                {a: dm.get_group(a) for a in axes}, dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract 16 x 16 pod mesh, or 2 x 16 x 16 across two pods."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def mesh_axes(mesh) -> dict:
    """Convenience: data-parallel axes tuple + model axis name."""
    names = tuple(mesh.axis_names)
    dp = tuple(a for a in names if a in ("pod", "data"))
    return {"dp": dp, "model": "model" if "model" in names else None,
            "all": names}


# Roofline constants of one NVIDIA H100 80GB HBM3 (SXM) at its 700 W
# power limit, from NVIDIA's data sheet: dense bf16 tensor-core rate, HBM3
# bandwidth, NVLink 4 bandwidth per direction (900 GB/s both ways), and
# the HBM capacity (80 GiB).
PEAK_FLOPS_BF16 = 989e12      # per card
HBM_BW = 3.35e12              # bytes/s per card
ICI_BW = 4.5e11               # NVLink bytes/s per direction per card
CHIP_HBM_BYTES = 80 * 2**30   # H100 80GB HBM capacity
