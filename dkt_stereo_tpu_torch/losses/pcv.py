"""PCVNet's loss (``dkt_stereo_tpu/losses/pcv.py``; the reference's
meta_arch/pcvnet/loss.py:4-73).

Per-iteration weights (0.4, 0.6, 0.8, 1, 1.2, 1.4), the last one for every
iteration beyond six, on the L1 of the mixture disparity plus the L1 of the
per-Gaussian means averaged over the Gaussians; plus 1.4 x smooth-L1 on the
refined disparity. The headline ``epe`` is read at iteration
``min(3, n - 1)``, as the reference reads ``final_disp_preds[3]``
(loss.py:53). The model works on positive disparities, so the
negative-flow GT is negated here. As in :mod:`losses.sequence`, the loss
comes back with a 0-dim bool ``ok`` and is zeroed when not ok.
"""

from __future__ import annotations

import torch

from dkt_stereo_tpu_torch.losses.sequence import _masked_mean, masked_count

_I_WEIGHTS = (0.4, 0.6, 0.8, 1.0, 1.2, 1.4)


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def sequence_loss_pcvnet(output_list, flow_gt: torch.Tensor, valid: torch.Tensor,
                         max_disp: float = 512.0):
    """``output_list``: (refined_up (B, H, W), disp_seq (N, B, H, W), mu_seq
    (N, B, H, W, G), w_seq, sigma_seq), positive disparities; ``flow_gt``
    (B, H, W) negative disparity; ``valid`` (B, H, W) in {0, 1}. Returns
    ``(loss, metrics, mask, ok)``: the mask keeps GT in [0, max_disp) with
    ``valid >= 0.5``; ``ok`` says GT, disparities, means and the refined
    disparity are finite; the metrics are epe, 1px, 3px, 5px, bad1, bad2,
    bad5 at the headline iteration and the same seven ``*_final`` ones of
    the refined disparity."""
    refined, disp_seq, mu_seq, _, _ = output_list
    disp_gt = -flow_gt.float()
    n = disp_seq.shape[0]
    if n < 1:
        raise ValueError("sequence_loss_pcvnet: no predictions")

    m = (disp_gt < max_disp) & (valid >= 0.5) & (disp_gt >= 0)
    ok = (torch.isfinite(torch.where(m, disp_gt, 0.0)).all() & torch.isfinite(disp_seq).all()
          & torch.isfinite(mu_seq).all() & torch.isfinite(refined).all())

    count = masked_count(m)
    loss = 0.0
    for i in range(n):
        wgt = _I_WEIGHTS[min(i, len(_I_WEIGHTS) - 1)]
        l1 = _masked_mean((disp_seq[i] - disp_gt).abs(), m, count)
        l2 = _masked_mean((mu_seq[i] - disp_gt[..., None]).abs().mean(-1), m, count)
        loss = loss + wgt * (l1 + l2)
    loss = loss + 1.4 * _masked_mean(_smooth_l1(refined - disp_gt), m, count)
    loss = torch.where(ok, loss, 0.0)

    metrics = {}
    for suffix, err in (("", (disp_seq[min(3, n - 1)] - disp_gt).abs()),
                        ("_final", (refined - disp_gt).abs())):
        metrics["epe" + suffix] = _masked_mean(err, m, count)
        for t in (1, 3, 5):
            metrics[f"{t}px{suffix}"] = _masked_mean((err < t).float(), m, count)
        for t in (1, 2, 5):
            metrics[f"bad{t}{suffix}"] = _masked_mean((err > t).float(), m, count)
    return loss, metrics, m, ok
