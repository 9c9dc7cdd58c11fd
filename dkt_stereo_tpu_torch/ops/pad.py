"""Input padding to divisibility constraints (the reference's ``InputPadder``,
core/utils/utils.py:7-26), over NHWC tensors.

  - ``"sintel"``: symmetric pad (H and W centered),
  - otherwise:    bottom-pad H, centered W.
Padding is replicate, as ``F.pad(mode='replicate')``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_dims(ht: int, wd: int, divis_by: int = 8, mode: str = "sintel"):
    """((top, bottom), (left, right)) pads; already-divisible dims pad by 0."""
    pad_ht = (((ht // divis_by) + 1) * divis_by - ht) % divis_by
    pad_wd = (((wd // divis_by) + 1) * divis_by - wd) % divis_by
    if mode == "sintel":
        return (pad_ht // 2, pad_ht - pad_ht // 2), (pad_wd // 2, pad_wd - pad_wd // 2)
    return (0, pad_ht), (pad_wd // 2, pad_wd - pad_wd // 2)


def pad_input(x: torch.Tensor, divis_by: int = 8, mode: str = "sintel"):
    """Replicate-pad NHWC ``x`` so H, W are multiples of ``divis_by``.
    Returns (padded, pad_spec); feed pad_spec to :func:`unpad_input`."""
    _, ht, wd, _ = x.shape
    (pt, pb), (pl, pr) = pad_dims(ht, wd, divis_by, mode)
    # F.pad's replicate mode pads the trailing dims of an NCHW tensor
    padded = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb), mode="replicate")
    return padded.permute(0, 2, 3, 1), ((pt, pb), (pl, pr))


def unpad_input(x: torch.Tensor, pad_spec: tuple) -> torch.Tensor:
    """Crop an NHWC tensor back (inverse of :func:`pad_input`)."""
    (pt, pb), (pl, pr) = pad_spec
    _, ht, wd, _ = x.shape
    return x[:, pt : ht - pb, pl : wd - pr, :]
