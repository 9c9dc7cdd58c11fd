"""Disparity visualization (numpy only): the port's copy of
``dkt_stereo_tpu/utils/visualization.py`` (the reference's
utils/visualization.py).

- ``disp_to_color``: jet colormap, scaled by max disparity (:219-262);
- ``disp_error_map``: the KITTI log-binned error colormap with the top-left
  legend strip (:21-73);
- ``epe_on_depth``: depth-binned EPE (:297-431, as a dict);
- ``disp_to_ply`` / ``disp_to_depth``: point-cloud export (:453-538).
"""

from __future__ import annotations

import numpy as np

# KITTI error colormap (utils/visualization.py:21-34): (lo, hi, r, g, b)
_ERROR_COLS = np.array(
    [
        [0 / 3.0, 0.1875 / 3.0, 49, 54, 149],
        [0.1875 / 3.0, 0.375 / 3.0, 69, 117, 180],
        [0.375 / 3.0, 0.75 / 3.0, 116, 173, 209],
        [0.75 / 3.0, 1.5 / 3.0, 171, 217, 233],
        [1.5 / 3.0, 3 / 3.0, 224, 243, 248],
        [3 / 3.0, 6 / 3.0, 254, 224, 144],
        [6 / 3.0, 12 / 3.0, 253, 174, 97],
        [12 / 3.0, 24 / 3.0, 244, 109, 67],
        [24 / 3.0, 48 / 3.0, 215, 48, 39],
        [48 / 3.0, np.inf, 165, 0, 38],
    ],
    dtype=np.float32,
)
_ERROR_COLS[:, 2:5] /= 255.0

# matplotlib's 'jet' segment data as a 256-entry LUT (the reference colors
# disparities with mpl's cm.jet, visualization.py:258-262)
_JET_N = 256


def _jet_lut() -> np.ndarray:
    xs = np.linspace(0.0, 1.0, _JET_N)
    r = np.interp(xs, [0.0, 0.35, 0.66, 0.89, 1.0], [0.0, 0.0, 1.0, 1.0, 0.5])
    g = np.interp(xs, [0.0, 0.125, 0.375, 0.64, 0.91, 1.0], [0.0, 0.0, 1.0, 1.0, 0.0, 0.0])
    b = np.interp(xs, [0.0, 0.11, 0.34, 0.65, 1.0], [0.5, 1.0, 1.0, 0.0, 0.0])
    return np.stack([r, g, b], axis=-1)


_JET_LUT = _jet_lut()


def _jet(x: np.ndarray) -> np.ndarray:
    """matplotlib 'jet' colormap on [0,1] → (..., 3) floats in [0,1];
    LUT-quantized like mpl's Colormap.__call__ (idx = int(x·N))."""
    idx = np.clip((np.asarray(x, np.float64) * _JET_N).astype(np.int64), 0, _JET_N - 1)
    return _JET_LUT[idx]


def disp_to_color(disp: np.ndarray, max_disp=None):
    """(H, W) disparity → ((1, 3, H, W) float RGB·255, max_disp), the
    reference's output layout (utils/visualization.py:255-262)."""
    h, w = disp.shape
    if max_disp is None:
        max_disp = float(np.max(disp))
    norm = disp / max_disp if max_disp > 0 else np.zeros_like(disp)
    rgb = _jet(norm).reshape(1, h, w, 3).transpose(0, 3, 1, 2)
    return rgb * 255.0, max_disp


def disp_error_map(D_est, D_gt, abs_thres=3.0, rel_thres=0.05, valid=None):
    """(B,H,W) est/gt → (B,3,H,W)·255 error visualization
    (utils/visualization.py:42-73)."""
    D_est = np.asarray(D_est, np.float32)
    D_gt = np.asarray(D_gt, np.float32)
    B, H, W = D_gt.shape
    mask = np.ones(D_gt.shape, dtype=bool)
    if valid is not None:
        mask &= np.asarray(valid) >= 0.5
    error = np.abs(D_gt - D_est)
    error[~mask] = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        error[mask] = np.minimum(
            error[mask] / abs_thres, (error[mask] / np.abs(D_gt[mask])) / rel_thres
        )
    img = np.zeros([B, H, W, 3], np.float32)
    for lo, hi, r, g, b in _ERROR_COLS:
        img[(error >= lo) & (error < hi)] = (r, g, b)
    img[~mask] = 0.0
    for i in range(len(_ERROR_COLS)):  # legend strip (:68-71)
        img[:, :10, i * 20 : (i + 1) * 20, :] = _ERROR_COLS[i, 2:]
    return np.ascontiguousarray(img.transpose(0, 3, 1, 2)) * 255.0


def epe_on_depth(disp_pred, disp_gt, valid_gt, focal=1446.0, baseline=0.1,
                 bins=(0, 10, 20, 30, np.inf)):
    """Depth-binned EPE (utils/visualization.py:297-431, returned as a dict
    instead of plotted)."""
    valid = np.asarray(valid_gt) >= 0.5
    disp_pred = np.abs(np.asarray(disp_pred, np.float64))
    disp_gt = np.abs(np.asarray(disp_gt, np.float64))
    depth_gt = focal * baseline / np.maximum(disp_gt, 1e-6)
    epe = np.abs(disp_pred - disp_gt)
    out = {}
    for lo, hi in zip(bins[:-1], bins[1:]):
        m = valid & (depth_gt >= lo) & (depth_gt < hi)
        out[f"epe_depth_{lo}_{hi}"] = float(epe[m].mean()) if m.any() else float("nan")
    return out


def disp_to_depth(disp, focal, baseline):
    """utils/visualization.py:513-538."""
    return focal * baseline / np.maximum(np.abs(disp), 1e-6)


def disp_to_ply(path, disp, image, focal, baseline):
    """Export a colored point cloud (utils/visualization.py:453-511): one
    vertex for every pixel with a nonzero disparity."""
    H, W = disp.shape
    depth = disp_to_depth(disp, focal, baseline)
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    X = (gx - W / 2.0) * depth / focal
    Y = (gy - H / 2.0) * depth / focal
    pts = np.stack([X, Y, depth], axis=-1).reshape(-1, 3)
    cols = np.asarray(image).reshape(-1, 3).astype(np.uint8)
    keep = np.isfinite(pts).all(axis=-1) & (np.abs(disp).reshape(-1) > 0)
    pts, cols = pts[keep], cols[keep]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for (x, y, z), (r, g, b) in zip(pts, cols):
            f.write(f"{x:.4f} {y:.4f} {z:.4f} {r} {g} {b}\n")
