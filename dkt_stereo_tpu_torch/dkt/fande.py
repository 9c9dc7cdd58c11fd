"""F&E (Filter-and-Ensemble) pseudo-label / GT augmentation
(``dkt_stereo_tpu/dkt/fande.py``; the reference's FandE/__init__.py:4-39).

Disparity maps are (B, H, W) and ``valid`` is (B, H, W) in {0, 1}. The
random draws are inputs: ``u`` (B,) for the stochastic filter and one scalar
``prob`` per ensemble call, so a test can feed the JAX package's draws (the
DKT step makes them from a ``torch.Generator``,
``train/dkt_step.py::fande_draws``).
"""

from __future__ import annotations

import torch


def fande_filter(source, target, valid, u=None, withprob: bool = False, threshold: float = 3.0):
    """FandE_Filter (FandE/__init__.py:24-39): keep source pixels within
    ``threshold`` of target. With ``withprob`` (the GT path) the
    inconsistent pixels of image b are re-admitted, all together, when
    ``u[b] < #consistent / #valid`` (``u``: (B,) uniforms, needed only with
    ``withprob``). Returns (filtered source, new valid)."""
    valid = valid.float()
    consistent = ((target - source).abs() < threshold).float() * valid
    source = source * valid
    if withprob:
        p = consistent.flatten(1).sum(-1) / valid.flatten(1).sum(-1).clamp_min(1.0)
        if u is None:
            raise ValueError("fande_filter: withprob needs the draws u")
        select = (u < p).float()[:, None, None]
        readmit = select * (1.0 - consistent) * valid
        new_valid = (consistent + (1.0 - consistent) * readmit) * valid
    else:
        new_valid = consistent
    return source * new_valid, new_valid


def fande_ensemble(source, target, valid, prob, clamp: float | bool = False,
                   threshold: float = 3.0):
    """FandE_Ensemble (FandE/__init__.py:4-21): where source and target are
    consistent, move source toward target by ``prob * |s - t|``, one
    uniform ``prob`` per call, capped at ``clamp`` when given (1 px on the
    GT path)."""
    valid = valid.float()
    consistent = ((target - source).abs() < threshold).float() * valid
    source = source * valid
    target = target * valid
    offset = prob * (source - target).abs()
    if clamp:
        offset = offset.clamp_max(float(clamp))
    aug = torch.sign(target - source) * offset * consistent
    return (source + aug) * valid
