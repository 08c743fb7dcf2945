"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  Never moves to the CPU silently: without
    CUDA the default raises and names the explicit CPU opt-in."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on device='cuda' by default, but CUDA is not "
            "available here; pass device='cpu' to run on the CPU")
    return dev
