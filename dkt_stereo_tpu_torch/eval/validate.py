"""Benchmark validators (``dkt_stereo_tpu/eval/validate.py``; the
reference's tools/evaluate_stereo.py:46-336) and the eval forward they and
the demo drive, one padded frame at a time.

Per-benchmark protocol, as in the JAX package (masks, thresholds,
aggregation):

| benchmark   | mask                                           | thresh | D1 aggregation |
|-------------|------------------------------------------------|--------|----------------|
| ETH3D       | valid ∧ gt<0 ∧ nocc==255                       | >1 px  | per-image mean |
| KITTI 12/15 | valid ∧ −maxdisp<gt<0                          | >3 px  | per-pixel concat (+FPS after 50 warm-up) |
| Things TEST | valid ∧ gt>−maxdisp  (NB: no gt<0 bound, :200) | >1 px  | per-pixel concat, NaN frames skipped |
| Middlebury  | valid ∧ −maxdisp<gt<0 ∧ nocc==255              | >2 px  | per-image mean |
| Booster-Q   | valid ∧ −maxdisp<gt<0                          | >2 px  | per-image mean |

All images run at batch 1, padded to multiples of ``divide_factor`` (32,
tools/evaluate_stereo.py:37) with symmetric replicate padding; disparity is
negative flow-x. The forward takes and returns tensors on
``forward.device``; :func:`_run_one` copies the disparity back to the host,
which waits for the card, so the KITTI frames per second are the card's.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from dkt_stereo_tpu_torch.data import readers
from dkt_stereo_tpu_torch.data.datasets import ETH3D, KITTI, Booster, Middlebury, SceneFlowDatasets
from dkt_stereo_tpu_torch.device import resolve_device
from dkt_stereo_tpu_torch.ops.pad import pad_input, unpad_input
from dkt_stereo_tpu_torch.train.profiling import span

logger = logging.getLogger(__name__)


def make_forward_fn(model: torch.nn.Module, device=None):
    """(img1, img2 NHWC in [0, 255], tensors or arrays) -> disp (B, H, W)
    fp32 on ``device`` (the GPU unless ``device="cpu"`` is passed). The
    model is moved there and put in eval mode; the forward runs under
    ``torch.inference_mode()``, in the span ``eval.forward`` (a frame's
    unit). The callable's ``device`` attribute names where its inputs
    should live."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def forward(img1, img2):
        with span("eval.forward"), torch.inference_mode():
            x1 = torch.as_tensor(img1, dtype=torch.float32, device=dev)
            x2 = torch.as_tensor(img2, dtype=torch.float32, device=dev)
            _, disp = model(x1, x2)
        return disp

    forward.device = dev
    return forward


def _run_one(forward, img1, img2, divide_factor=32):
    """One (H, W, 3) pair -> (disp (H, W) numpy, seconds). Symmetric
    replicate padding to multiples of ``divide_factor`` (32 in the reference
    eval, tools/evaluate_stereo.py:37); the time covers the forward, the
    unpad and the copy back to the host."""
    dev = forward.device
    x1, spec = pad_input(torch.as_tensor(img1, dtype=torch.float32, device=dev)[None],
                         divide_factor, "sintel")
    x2, _ = pad_input(torch.as_tensor(img2, dtype=torch.float32, device=dev)[None],
                      divide_factor, "sintel")
    t0 = time.perf_counter()
    disp = forward(x1, x2)
    disp = unpad_input(disp[..., None], spec)[0, ..., 0].cpu().numpy()
    dt = time.perf_counter() - t0
    return np.asarray(disp), dt


def _require_frames(ds, data_root):
    # an absent or empty dataset fails loudly instead of aggregating to NaN
    if len(ds) == 0:
        raise FileNotFoundError(f"no frames found under {data_root!r}")


def resolve_eval_dataset(name, data_root):
    """The eval CLI's dataset names (``eth3d``, ``middlebury-H``,
    ``kitti-2012``, ``booster-Q``, ``things``), shared by :func:`preflight`
    and :func:`run_validator`. Returns ``(kind, variant, root)``."""
    if name == "eth3d":
        return "eth3d", None, f"{data_root}/ETH3D"
    if name.startswith("middlebury"):
        return "middlebury", name.split("-")[1] if "-" in name else "H", f"{data_root}/Middlebury"
    if name.startswith("kitti"):
        return "kitti", name.split("-")[1] if "-" in name else "2015", f"{data_root}/KITTI"
    if name.startswith("booster"):
        return "booster", name.split("-")[1] if "-" in name else "Q", f"{data_root}/Booster_dataset"
    if name == "things":
        return "things", None, f"{data_root}/sceneflow"
    raise ValueError(name)


def _dataset_for(kind, variant, root):
    if kind == "eth3d":
        return ETH3D(None, root=root)
    if kind == "middlebury":
        return Middlebury(None, root=root, resolution=variant)
    if kind == "kitti":
        return KITTI(None, root=root, split=variant)
    if kind == "booster":
        return Booster(None, root=root, resolution=variant)
    return SceneFlowDatasets(None, root=root, dstype="frames_finalpass", things_test=True)


def run_validator(name, forward, data_root, divide_factor=32):
    """Dispatch one eval-CLI dataset name to its validator."""
    kind, variant, root = resolve_eval_dataset(name, data_root)
    if kind == "eth3d":
        return validate_eth3d(forward, root, divide_factor)
    if kind == "middlebury":
        return validate_middlebury(forward, variant, root, divide_factor=divide_factor)
    if kind == "kitti":
        return validate_kitti(forward, variant, root, divide_factor=divide_factor)
    if kind == "booster":
        return validate_booster(forward, variant, root, divide_factor=divide_factor)
    return validate_things(forward, root, divide_factor=divide_factor)


def preflight(names, data_root):
    """Fail fast on empty or absent eval datasets before the model is built
    (dataset construction is a cheap filesystem glob)."""
    for name in names:
        kind, variant, root = resolve_eval_dataset(name, data_root)
        _require_frames(_dataset_for(kind, variant, root), f"{root} ({name})")


def validate_eth3d(forward, data_root="data/ETH3D", divide_factor=32):
    """tools/evaluate_stereo.py:46-104."""
    ds = ETH3D(None, root=data_root)
    _require_frames(ds, data_root)
    out_list, epe_list = [], []
    for i in range(len(ds)):
        img1, img2, flow_gt, valid_gt = ds.get_sample(i)
        occ = np.array(
            readers.read_gen(ds.disparity_list[i].replace("disp0GT.pfm", "mask0nocc.png")))
        pred, _ = _run_one(forward, img1, img2, divide_factor)
        epe = np.abs(pred - flow_gt)
        val = (valid_gt >= 0.5) & (flow_gt < 0) & (occ == 255)
        out = epe > 1.0
        epe_list.append(epe[val].mean())
        out_list.append(out[val].mean())
        logger.info("ETH3D %d/%d EPE %.4f D1 %.4f", i + 1, len(ds), epe_list[-1], out_list[-1])
    return {"eth3d-epe": float(np.mean(epe_list)), "eth3d-d1": 100 * float(np.mean(out_list))}


def validate_kitti(forward, split="2015", data_root="data/KITTI", maxdisp=192, divide_factor=32):
    """tools/evaluate_stereo.py:108-171, with the frames per second of the
    frames after the first 51 (the reference's warm-up)."""
    ds = KITTI(None, root=data_root, split=split)
    _require_frames(ds, f"{data_root} (split {split})")
    out_list, epe_list, elapsed = [], [], []
    for i in range(len(ds)):
        img1, img2, flow_gt, valid_gt = ds.get_sample(i)
        pred, dt = _run_one(forward, img1, img2, divide_factor)
        if i > 50:
            elapsed.append(dt)
        epe = np.abs(pred - flow_gt)
        val = (valid_gt >= 0.5) & (flow_gt > -maxdisp) & (flow_gt < 0)
        out = epe > 3.0
        epe_list.append(epe[val].mean())
        out_list.append(out[val])
    d1 = 100 * float(np.mean(np.concatenate(out_list)))
    res = {f"kitti-{split}-epe": float(np.mean(epe_list)), f"kitti-{split}-d1": d1}
    if elapsed:
        res[f"kitti-{split}-fps"] = 1.0 / float(np.mean(elapsed))
    return res


def validate_things(forward, data_root="data/sceneflow", maxdisp=192, divide_factor=32):
    """tools/evaluate_stereo.py:175-213."""
    ds = SceneFlowDatasets(None, root=data_root, dstype="frames_finalpass", things_test=True)
    _require_frames(ds, data_root)
    out_list, epe_list = [], []
    for i in range(len(ds)):
        img1, img2, flow_gt, valid_gt = ds.get_sample(i)
        pred, _ = _run_one(forward, img1, img2, divide_factor)
        epe = np.abs(pred - flow_gt)
        val = (valid_gt >= 0.5) & (flow_gt > -maxdisp)
        m = epe[val].mean()
        if np.isnan(m):
            continue  # :203-204
        epe_list.append(m)
        out_list.append((epe > 1.0)[val])
    return {
        "things-epe": float(np.mean(epe_list)),
        "things-d1": 100 * float(np.mean(np.concatenate(out_list))),
    }


def validate_middlebury(forward, resolution="H", data_root="data/Middlebury", maxdisp=192,
                        divide_factor=32):
    """tools/evaluate_stereo.py:216-275 (the reference's final print, a
    NameError, is not reproduced). The non-occlusion mask is read as PIL's
    ``convert("L")`` reads it (:func:`readers.luma`)."""
    ds = Middlebury(None, root=data_root, resolution=resolution)
    _require_frames(ds, data_root)
    out_list, epe_list = [], []
    for i in range(len(ds)):
        img1, img2, flow_gt, valid_gt = ds.get_sample(i)
        occ = readers.luma(readers.read_gen(
            ds.image_list[i][0].replace("im0.png", "mask0nocc.png"))).astype(np.float32)
        pred, _ = _run_one(forward, img1, img2, divide_factor)
        epe = np.abs(pred - flow_gt)
        val = (valid_gt >= 0.5) & (flow_gt > -maxdisp) & (flow_gt < 0) & (occ == 255)
        epe_list.append(epe[val].mean())
        out_list.append((epe > 2.0)[val].mean())
    return {
        f"middlebury{resolution}-epe": float(np.mean(epe_list)),
        f"middlebury{resolution}-d1": 100 * float(np.mean(out_list)),
    }


def validate_booster(forward, resolution="Q", data_root="data/Booster_dataset", maxdisp=192,
                     divide_factor=32):
    """tools/evaluate_stereo.py:279-336."""
    ds = Booster(None, root=data_root, resolution=resolution)
    _require_frames(ds, data_root)
    out_list, epe_list = [], []
    for i in range(len(ds)):
        img1, img2, flow_gt, valid_gt = ds.get_sample(i)
        pred, _ = _run_one(forward, img1, img2, divide_factor)
        epe = np.abs(pred - flow_gt)
        val = (valid_gt >= 0.5) & (flow_gt > -maxdisp) & (flow_gt < 0)
        epe_list.append(epe[val].mean())
        out_list.append((epe > 2.0)[val].mean())
    return {
        "Booster-epe": float(np.mean(epe_list)),
        "Booster-d1": 100 * float(np.mean(out_list)),
    }
