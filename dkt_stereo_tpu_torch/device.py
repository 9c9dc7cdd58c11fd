"""Device policy of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU: raise when there is none rather than drift to
    the CPU. The CPU is used only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU unless "
                "device='cpu' is passed explicitly"
            )
        return torch.device("cuda")
    return torch.device(device)
