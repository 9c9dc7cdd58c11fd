"""Disparity metrics (numpy, host-side): the port's copy of
``dkt_stereo_tpu/eval/metrics.py`` (the reference's utils/metrics.py).

Includes the per-image wrapper that skips frames whose mask covers < 10% of
the GT-positive pixels (utils/metrics.py:22-40)."""

from __future__ import annotations

import numpy as np


def _per_image(metric):
    def wrapper(D_est, D_gt, mask, *args):
        assert D_est.ndim == 3, "expect (B, H, W)"
        results = []
        for i in range(D_gt.shape[0]):
            gt_pos = (D_gt[i] > 0).mean()
            if gt_pos == 0 or mask[i].mean() / gt_pos < 0.1:
                continue  # utils/metrics.py:31-32
            results.append(metric(D_est[i], D_gt[i], mask[i].astype(bool), *args))
        return float(np.mean(results)) if results else 0.0

    return wrapper


@_per_image
def D1_metric(D_est, D_gt, mask):
    """Official KITTI D1: >3px AND >5% relative (utils/metrics.py:43-49)."""
    e, g = D_est[mask], D_gt[mask]
    E = np.abs(g - e)
    return float(((E > 3) & (E / np.abs(g) > 0.05)).mean())


@_per_image
def Thres_metric(D_est, D_gt, mask, thres):
    e, g = D_est[mask], D_gt[mask]
    return float((np.abs(g - e) > thres).mean())


@_per_image
def EPE_metric(D_est, D_gt, mask):
    e, g = D_est[mask], D_gt[mask]
    return float(np.abs(g - e).mean())
