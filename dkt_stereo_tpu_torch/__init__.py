"""PyTorch/CUDA port of dkt_stereo_tpu for NVIDIA Hopper (H100).

The package mirrors the JAX package's module paths (``models/``, ``nn/``,
``ops/``, ``eval/``, ``cli/``) and keeps its public conventions: NHWC images
in [0, 255] and disparity as negative flow-x. Modules run NCHW inside.

It imports torch, numpy and the standard library only; the TPU kernels of
the JAX package are replaced by hand-written CUDA C++ kernels in ``csrc/``,
built with nvcc on first use (``ops/cuda/_build.py``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from dkt_stereo_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
