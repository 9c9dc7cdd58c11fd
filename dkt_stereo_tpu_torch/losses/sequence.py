"""Sequence losses (``dkt_stereo_tpu/losses/sequence.py``): RAFT's
(:22-57; the reference's meta_arch/raft_stereo/loss.py:3-41) and IGEV's
(:60-112).

The reference returns ``(None, None, None)`` on non-finite GT or
predictions, and the training loop then skips the step. Here, as in the JAX
package, the loss comes back with a 0-dim bool ``ok`` and is zeroed when not
ok; the DKT step skips the update on ``ok`` without a graph break.

Every masked mean divides by the mask's count over all ranks of the
process group (``parallel/mesh.py::all_sum``; the mask's own count in one
process): JAX's sharded step divides a global sum by a global count, and a
rank's loss is then its own numerators over that count, so that the ranks'
losses and gradients add up to the global batch's. An average of the
ranks' own means would differ wherever their valid pixels differ in number.
"""

from __future__ import annotations

import torch

from dkt_stereo_tpu_torch.parallel.mesh import all_sum


def masked_count(mask: torch.Tensor) -> torch.Tensor:
    """The true entries of ``mask`` on every rank, at least 1: the
    denominator of a masked mean."""
    return all_sum(mask.sum().float()).clamp_min(1.0)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, count: torch.Tensor | None = None):
    """The sum of ``x`` where ``mask`` holds over ``count`` (by default
    :func:`masked_count` of ``mask``; pass it to share one count)."""
    if count is None:
        count = masked_count(mask)
    return torch.where(mask, x, 0.0).sum() / count


def sequence_loss_raft(disp_preds: torch.Tensor, flow_gt: torch.Tensor, valid: torch.Tensor,
                       loss_gamma: float = 0.9, max_flow: float = 700.0):
    """``disp_preds`` (N, B, H, W), ``flow_gt`` (B, H, W) negative
    disparity, ``valid`` (B, H, W) in {0, 1}. Returns ``(loss, metrics, mask,
    ok)``: the gamma-weighted L1 over iterations (gamma adjusted for N,
    loss.py:25), the last iteration's EPE and 1/3/5 px rates, the pixel mask
    and whether GT and predictions are finite."""
    n = disp_preds.shape[0]
    if n < 1:
        raise ValueError("sequence_loss_raft: no predictions")
    flow_gt = flow_gt.float()
    preds = disp_preds.float()

    # 1-channel L2 == abs (loss.py:11)
    m = (valid >= 0.5) & (flow_gt.abs() < max_flow)
    ok = torch.isfinite(torch.where(m, flow_gt, 0.0)).all() & torch.isfinite(preds).all()

    gamma_adj = loss_gamma ** (15.0 / (n - 1)) if n > 1 else 1.0
    weights = torch.tensor([gamma_adj ** (n - 1 - i) for i in range(n)], dtype=torch.float32,
                           device=preds.device)
    abs_err = (preds - flow_gt[None]).abs()
    count = masked_count(m)
    per_iter = torch.stack([_masked_mean(abs_err[i], m, count) for i in range(n)])
    loss = torch.where(ok, (weights * per_iter).sum(), 0.0)

    epe = (preds[-1] - flow_gt).abs()
    metrics = {
        "epe": _masked_mean(epe, m, count),
        "1px": _masked_mean((epe < 1).float(), m, count),
        "3px": _masked_mean((epe < 3).float(), m, count),
        "5px": _masked_mean((epe < 5).float(), m, count),
    }
    return loss, metrics, m, ok


def sequence_loss_igev(disp_preds: torch.Tensor, init_disp: torch.Tensor, flow_gt: torch.Tensor,
                       valid: torch.Tensor, loss_gamma: float = 0.9, max_disp: float = 192.0):
    """IGEV's loss (the JAX package's ``sequence_loss_igev``; the
    reference ships an empty loss file for IGEV, and this is upstream
    IGEV-Stereo's): a unit-weight smooth-L1 term on the upsampled initial
    disparity plus :func:`sequence_loss_raft`'s gamma-weighted L1 over
    ``disp_preds`` (N, B, H, W), over the pixels with ``valid >= 0.5`` and
    ``|gt| < max_disp``. The init term is what trains the cost aggregation
    and the init upsampling besides the lookup's backward, since every
    iteration detaches the incoming disparity. ``ok`` covers GT,
    predictions and init; metrics add ``init_epe``. Returns ``(loss,
    metrics, mask, ok)``."""
    n = disp_preds.shape[0]
    if n < 1:
        raise ValueError("sequence_loss_igev: no predictions")
    flow_gt = flow_gt.float()
    preds = disp_preds.float()
    init = init_disp.float()

    m = (valid >= 0.5) & (flow_gt.abs() < max_disp)
    ok = (torch.isfinite(torch.where(m, flow_gt, 0.0)).all() & torch.isfinite(preds).all()
          & torch.isfinite(init).all())

    err0 = (init - flow_gt).abs()
    smooth_l1 = torch.where(err0 < 1.0, 0.5 * err0 * err0, err0 - 0.5)
    gamma_adj = loss_gamma ** (15.0 / (n - 1)) if n > 1 else 1.0
    weights = torch.tensor([gamma_adj ** (n - 1 - i) for i in range(n)], dtype=torch.float32,
                           device=preds.device)
    abs_err = (preds - flow_gt[None]).abs()
    count = masked_count(m)
    per_iter = torch.stack([_masked_mean(abs_err[i], m, count) for i in range(n)])
    loss = torch.where(ok, _masked_mean(smooth_l1, m, count) + (weights * per_iter).sum(), 0.0)

    epe = (preds[-1] - flow_gt).abs()
    metrics = {
        "epe": _masked_mean(epe, m, count),
        "init_epe": _masked_mean(err0, m, count),
        "1px": _masked_mean((epe < 1).float(), m, count),
        "3px": _masked_mean((epe < 3).float(), m, count),
        "5px": _masked_mean((epe < 5).float(), m, count),
    }
    return loss, metrics, m, ok
