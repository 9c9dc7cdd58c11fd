"""GWCNet's stacked-hourglass loss (``dkt_stereo_tpu/losses/gwc.py``; the
reference's meta_arch/gwcnet/gwc_loss.py:5-31): a smooth-L1 per head with
weights (0.5, 0.5, 0.7, 1.0) over the pixels with ``valid >= 0.5`` and
``|gt| < maxdisp``. The reference asserts that nothing is infinite; here, as
in :mod:`losses.sequence`, the loss comes back zeroed with ``ok`` false."""

from __future__ import annotations

import torch

from dkt_stereo_tpu_torch.losses.sequence import _masked_mean, masked_count

_WEIGHTS = (0.5, 0.5, 0.7, 1.0)


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def epe_metrics(pred: torch.Tensor, flow_gt: torch.Tensor, m: torch.Tensor,
                count: torch.Tensor | None = None) -> dict:
    """EPE and the 1/3/5 px rates of ``pred`` over the mask ``m`` (whose
    global count is ``count``, counted here when not given)."""
    if count is None:
        count = masked_count(m)
    epe = (pred - flow_gt).abs()
    return {
        "epe": _masked_mean(epe, m, count),
        "1px": _masked_mean((epe < 1).float(), m, count),
        "3px": _masked_mean((epe < 3).float(), m, count),
        "5px": _masked_mean((epe < 5).float(), m, count),
    }


def loss_gwcnet(disp_preds: torch.Tensor, flow_gt: torch.Tensor, valid: torch.Tensor,
                maxdisp: float = 192.0):
    """``disp_preds`` (N <= 4, B, H, W) negative disparity; ``flow_gt`` and
    ``valid`` (B, H, W). Returns ``(loss, metrics, mask, ok)``; the metrics
    are the last head's EPE and 1/3/5 px rates."""
    flow_gt = flow_gt.float()
    preds = disp_preds.float()
    m = (valid >= 0.5) & (flow_gt.abs() < maxdisp)
    ok = torch.isfinite(torch.where(m, flow_gt, 0.0)).all() & torch.isfinite(preds).all()
    count = masked_count(m)
    loss = sum(w * _masked_mean(smooth_l1(preds[i] - flow_gt), m, count)
               for i, w in enumerate(_WEIGHTS[: preds.shape[0]]))
    return torch.where(ok, loss, 0.0), epe_metrics(preds[-1], flow_gt, m, count), m, ok
