"""CGI-Stereo's loss (``dkt_stereo_tpu/losses/cgi.py``; the reference's
meta_arch/cgi/loss.py:4-11, whose signature no caller can use): the
smooth-L1 of the quarter-resolution head against every 4th row and column
of the GT (weight 0.3) plus that of the full-resolution head (weight 1.0),
with the ``(loss, metrics, mask, ok)`` contract of :mod:`losses.gwc`."""

from __future__ import annotations

import torch

from dkt_stereo_tpu_torch.losses.gwc import epe_metrics, smooth_l1
from dkt_stereo_tpu_torch.losses.sequence import _masked_mean
from dkt_stereo_tpu_torch.parallel.mesh import all_sum

_WEIGHTS = (0.3, 1.0)


def loss_cgi(disp_preds, flow_gt: torch.Tensor, valid: torch.Tensor, maxdisp: float = 192.0):
    """``disp_preds``: [quarter (B, H/4, W/4), full (B, H, W)] negative
    disparities. The metrics are the full-resolution head's."""
    flow_gt = flow_gt.float()
    m = (valid >= 0.5) & (flow_gt.abs() < maxdisp)
    gt_q, m_q = flow_gt[:, ::4, ::4], m[:, ::4, ::4]
    p_q, p_f = (p.float() for p in disp_preds)
    ok = (torch.isfinite(torch.where(m, flow_gt, 0.0)).all() & torch.isfinite(p_q).all()
          & torch.isfinite(p_f).all())
    # both masks' global counts in one all_reduce
    counts = all_sum(torch.stack([m_q.sum(), m.sum()]).float()).clamp_min(1.0)
    loss = (_WEIGHTS[0] * _masked_mean(smooth_l1(p_q - gt_q), m_q, counts[0])
            + _WEIGHTS[1] * _masked_mean(smooth_l1(p_f - flow_gt), m, counts[1]))
    return torch.where(ok, loss, 0.0), epe_metrics(p_f, flow_gt, m, counts[1]), m, ok
