"""Eval forward (``dkt_stereo_tpu/eval/validate.py:49-79``): the callable
that the benchmark validators and the demo drive, one padded frame at a
time."""

from __future__ import annotations

import time

import numpy as np
import torch

from dkt_stereo_tpu_torch.device import resolve_device
from dkt_stereo_tpu_torch.ops.pad import pad_input, unpad_input


def make_forward_fn(model: torch.nn.Module, device=None):
    """(img1, img2 NHWC in [0, 255], tensors or arrays) -> disp (B, H, W)
    fp32 on ``device`` (the GPU unless ``device="cpu"`` is passed). The
    model is moved there and put in eval mode; the forward runs under
    ``torch.inference_mode()``. The callable's ``device`` attribute names
    where its inputs should live."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def forward(img1, img2):
        with torch.inference_mode():
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
