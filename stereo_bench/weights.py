"""Seeded weights for a reference model's parameter names, made on the
device in two draws, for any model of convolutions, linear layers and
norms (1-D to 3-D, transposed or not).

- Every convolution's and linear layer's weight is N(0, 2 / fan_out), with
  fan_out its first dimension times its kernel's size
  (``kaiming_normal_(mode="fan_out")``, the rule of upstream RAFT-Stereo's
  encoders); its bias is U(-1/sqrt(fan_in), 1/sqrt(fan_in)), PyTorch's
  default, which upstream's init keeps.
- Every batch norm has weight U(0.75, 1.25), bias U(-0.25, 0.25), running
  mean U(-0.25, 0.25) and running variance U(0.5, 2): statistics that a
  trained model has, so that a program which skips them, or folds them
  wrongly, gives another answer. Group, layer and instance norms with an
  affine take the same weight and bias.

The entries that a configuration's ``init_scale`` names are then scaled:
RAFT's flow head, which keeps the recurrence of random weights from
amplifying rounding (a 1e-7 nudge moves a 7-iteration frame of unscaled
random RAFT by ~4 px) and sets the size of its disparities; every module
still runs and costs what it costs. A module of another kind with
parameters or buffers is refused by name.
"""

from __future__ import annotations

import torch
from torch import nn

_CONV = (nn.modules.conv._ConvNd, nn.Linear)
_BN = nn.modules.batchnorm._BatchNorm
_AFFINE = (nn.GroupNorm, nn.LayerNorm, nn.modules.instancenorm._InstanceNorm)
# (low, high) of the uniform draws
BN_WEIGHT, BN_BIAS, BN_MEAN, BN_VAR = (0.75, 1.25), (-0.25, 0.25), (-0.25, 0.25), (0.5, 2.0)


def _fans(shape):
    field = shape[2:].numel() if len(shape) > 2 else 1
    return shape[1] * field, shape[0] * field  # fan_in, fan_out


def seeded_state_dict(model: nn.Module, seed: int, device, scaled: dict) -> dict:
    """The state dict of ``model``'s names and shapes, fp32 on ``device``,
    drawn from ``seed`` with one ``randn`` and one ``rand`` call;
    ``scaled`` (a configuration's ``init_scale``) maps entries to factors."""
    normal, uniform, fixed = [], [], {}  # (key, shape, std) / (key, shape, low, high)
    first, aliases = {}, {}  # a module registered twice (RAFT's norm3 is downsample.1)
    for name, m in model.named_modules(remove_duplicate=False):
        pre = f"{name}." if name else ""
        if id(m) in first:
            aliases[pre] = first[id(m)]
            continue
        first[id(m)] = pre
        if isinstance(m, _CONV):
            fan_in, fan_out = _fans(m.weight.shape)
            normal.append((pre + "weight", m.weight.shape, (2.0 / fan_out) ** 0.5))
            if m.bias is not None:
                b = fan_in ** -0.5
                uniform.append((pre + "bias", m.bias.shape, -b, b))
        elif isinstance(m, _BN):
            if m.affine:
                uniform += [(pre + "weight", m.weight.shape, *BN_WEIGHT),
                            (pre + "bias", m.bias.shape, *BN_BIAS)]
            if m.track_running_stats:
                uniform += [(pre + "running_mean", m.running_mean.shape, *BN_MEAN),
                            (pre + "running_var", m.running_var.shape, *BN_VAR)]
                fixed[pre + "num_batches_tracked"] = torch.zeros((), dtype=torch.long,
                                                                 device=device)
        elif isinstance(m, _AFFINE) and getattr(m, "weight", None) is not None:
            uniform += [(pre + "weight", m.weight.shape, *BN_WEIGHT),
                        (pre + "bias", m.bias.shape, *BN_BIAS)]
    gen = torch.Generator(device=device).manual_seed(seed)
    entries = dict(fixed)
    flat = torch.randn(sum(s.numel() for _, s, _ in normal), generator=gen, device=device)
    offset = 0
    for key, shape, std in normal:
        entries[key] = flat[offset:offset + shape.numel()].view(shape) * std
        offset += shape.numel()
    flat = torch.rand(sum(s.numel() for _, s, _, _ in uniform), generator=gen, device=device)
    offset = 0
    for key, shape, lo, hi in uniform:
        entries[key] = lo + (hi - lo) * flat[offset:offset + shape.numel()].view(shape)
        offset += shape.numel()
    for key, factor in scaled.items():
        entries[key] = entries[key] * factor
    for pre, base in aliases.items():
        entries.update({pre + k[len(base):]: v for k, v in list(entries.items())
                        if k.startswith(base) and "." not in k[len(base):]})
    keys = set(model.state_dict())
    if set(entries) != keys:
        raise ValueError(f"weights for unknown modules: {sorted(keys ^ set(entries))[:5]}")
    return entries
