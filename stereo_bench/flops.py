"""Model FLOPs of a cell's unit of work, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the configuration's plain
model reference (:mod:`stereo_bench.harness`) on meta tensors (no memory,
no arithmetic): convolutions and matrix products, two operations a
multiply-add. The cells keep the counts as data (``flops_per_unit``, a
frame's or a step's); ``python -m stereo_bench.flops <workload>`` prints
the count of a workload file, and the tests hold the files to it.

A frame is one test-mode forward at the padded size. A DKT step is both
teachers' test-mode forwards, the student's train-mode forward and its
backward, without the recomputation of ``remat_iters``.
"""

from __future__ import annotations

import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from stereo_bench import harness


def _images(B, H, W, requires_grad=False):
    return [torch.empty((B, H, W, 3), device="meta", requires_grad=requires_grad)
            for _ in range(2)]


def frame_flops(ref, model_config: dict, B: int, H: int, W: int, iters: int) -> int:
    with torch.device("meta"):
        model = ref.build(model_config)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.disparity(model, *_images(B, H, W), iters)
    return counter.get_total_flops()


def dkt_step_flops(ref, model_config: dict, B: int, H: int, W: int, train_iters: int,
                   teacher_iters: int) -> int:
    with torch.device("meta"):
        model = ref.build(model_config)
    counter = FlopCounterMode(display=False)
    with counter:
        with torch.no_grad():
            for _ in range(2):
                ref.disparity(model, *_images(B, H, W), teacher_iters)
        ref.train_forward(model, *_images(B, H, W), train_iters).sum().backward()
    return counter.get_total_flops()


def workload_flops(name: str, root=harness.ROOT) -> int:
    """The count of a workload file's unit of work (a frame or a step) at its
    own sizes, by its driver's ``unit_flops``."""
    cell = harness.load_json(root, "workloads", name)
    config = harness.load_json(root, "configs", cell["config"])
    ref = harness.load_code(root, "reference", config["reference"])
    return harness.load_code(root, "drivers", cell["driver"]).unit_flops(cell, config, ref)


if __name__ == "__main__":
    for arg in sys.argv[1:]:
        print(arg, workload_flops(arg))
