"""NeRF-Stereo loss (``dkt_stereo_tpu/losses/nerf.py``; the reference's
meta_arch/nerf_stereo/loss.py:92-181).

A confidence-weighted disparity L1 plus a trinocular photometric term
(0.15 L1 + 0.85 SSIM distance, the min over the left and right
reconstructions, automasked) with a gamma decay over the iterations.
Disparities are negative throughout (the reference's own comment at :129).
The reference's ``binocular_loss`` reads an undefined ``valid`` (:120, dead
code); only the trinocular path is ported, as in the JAX package. Its masked
means divide by global counts, as :mod:`losses.sequence`'s do.
"""

from __future__ import annotations

import torch

from dkt_stereo_tpu_torch.losses.sequence import masked_count
from dkt_stereo_tpu_torch.ops.warp import disp_warp, ssim
from dkt_stereo_tpu_torch.parallel.mesh import all_sum


def photometric_loss(im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
    """loss.py:87-91: ``0.15 L1 + 0.85 SSIM`` distance, averaged over the
    channels of NHWC images -> (B, H, W)."""
    l1 = (im1 - im2).abs().mean(dim=-1)
    s = ssim(im2, im1).mean(dim=-1)
    return 0.15 * l1 + 0.85 * s


def _trinocular_terms(disp, im1, im2, im3, uncertainty, valid, loss_2=None):
    """:func:`trinocular_loss`'s numerator and this rank's automask count."""
    rec12, mask12 = disp_warp(im1, disp, r2l=True)
    rec23, mask23 = disp_warp(im3, disp, r2l=False)
    pl12 = photometric_loss(im2, mask12 * rec12)
    pl23 = photometric_loss(im2, mask23 * rec23)
    loss_warp = torch.minimum(pl12, pl23)
    if loss_2 is None:
        loss_2 = automask_reference(im1, im2, im3)
    automask = (loss_warp < loss_2) & (valid >= 0.5)
    return torch.where(automask, loss_warp * uncertainty, 0.0).sum(), automask.sum().float()


def trinocular_loss(disp, im1, im2, im3, uncertainty, valid, loss_2=None):
    """loss.py:92-109. ``disp`` (B, H, W, 1) negative; images (B, H, W, 3);
    ``uncertainty`` and ``valid`` (B, H, W). ``loss_2``, the automask's
    photometric loss of the unwarped neighbours, does not depend on
    ``disp``: a caller that scores several disparities passes it once
    (:func:`automask_reference`). The automask's count is the global one
    (the module docstring of :mod:`losses.sequence`)."""
    num, count = _trinocular_terms(disp, im1, im2, im3, uncertainty, valid, loss_2)
    return num / all_sum(count).clamp_min(1.0)


def automask_reference(im1, im2, im3) -> torch.Tensor:
    """The automask's threshold: the photometric loss of the centre view
    against each neighbour unwarped, the smaller of the two (B, H, W)."""
    return torch.minimum(photometric_loss(im2, im1), photometric_loss(im2, im3))


def ns_loss(pred_disps, target_disp, conf, im0, im1, im2, alpha_disp_loss: float = 1.0,
            alpha_photometric: float = 0.1, conf_threshold: float = 0.5,
            max_flow: float = 512.0, loss_gamma: float = 0.9):
    """``pred_disps`` (N, B, H, W) and ``target_disp`` (B, H, W) negative;
    ``conf`` (B, H, W); ``im0``, ``im1``, ``im2`` (B, H, W, 3) the clean
    triplet. Returns ``(loss, metrics, mask, ok)``: the gamma-weighted sum
    over the iterations (gamma adjusted to ``loss_gamma ** (15 / (N -
    1))``) of the confidence-weighted L1 over the pixels with confidence
    above ``conf_threshold`` and ``|target| < max_flow``, plus
    ``alpha_photometric`` times the trinocular loss weighted by ``1 -
    conf``; 0 unless the masked target and the predictions are finite
    (``ok``). Metrics: the last iteration's EPE and 1/3/5 px rates."""
    target = target_disp.float()
    preds = pred_disps.float()
    n = preds.shape[0]

    conf = conf * (target < 0).float()
    valid = (conf > conf_threshold).float()
    m = (valid >= 0.5) & (target.abs() < max_flow)
    ok = torch.isfinite(torch.where(m, target, 0.0)).all() & torch.isfinite(preds).all()

    gamma_adj = loss_gamma ** (15.0 / (n - 1)) if n > 1 else 1.0
    count = masked_count(m)
    loss_2 = automask_reference(im0, im1, im2) if alpha_photometric != 0.0 else None
    disp_loss = photo_loss = 0.0
    photo_terms = []
    for i in range(n):
        w = gamma_adj ** (n - 1 - i)
        diff = (preds[i] - target).abs() * conf
        disp_loss = disp_loss + w * (torch.where(m, diff, 0.0).sum() / count)
        if alpha_photometric != 0.0:
            photo_terms.append((w, *_trinocular_terms(
                preds[i][..., None], im0, im1, im2, 1.0 - conf, m.float(), loss_2)))
    if photo_terms:  # every iteration's automask count over the ranks, one all_reduce
        counts = all_sum(torch.stack([c for _, _, c in photo_terms])).clamp_min(1.0)
        for (w, num, _), c in zip(photo_terms, counts):
            photo_loss = photo_loss + w * (num / c)
    loss = alpha_disp_loss * disp_loss + alpha_photometric * photo_loss
    loss = torch.where(ok, loss, 0.0)

    epe = (preds[-1] - target).abs()
    metrics = {
        "epe": torch.where(m, epe, 0.0).sum() / count,
        "1px": torch.where(m, (epe < 1).float(), 0.0).sum() / count,
        "3px": torch.where(m, (epe < 3).float(), 0.0).sum() / count,
        "5px": torch.where(m, (epe < 5).float(), 0.0).sum() / count,
    }
    return loss, metrics, m, ok
