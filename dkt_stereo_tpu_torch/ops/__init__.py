"""Array ops over NCHW tensors (``dkt_stereo_tpu/ops``), exported by name as
the JAX package exports them. A name's module is imported at its first use
(PEP 562), so importing one module of the package does not import the
others (``ops/resize.py`` and ``nn/norms.py`` import each other's
packages)."""

from __future__ import annotations

import importlib

_EXPORTS = {
    "pad": ("pad_dims", "pad_input", "unpad_input"),
    "sampler": ("bilinear_sampler", "coords_grid_x", "sample_row_1d"),
    "resize": ("avg_pool2d", "interp_bilinear_align", "pool2x", "pool4x", "upflow"),
    "corr": ("corr_lookup", "corr_pyramid", "corr_volume"),
    "upsample": ("convex_upsample", "context_upsample"),
    "volumes": ("build_concat_volume", "build_gwc_volume", "build_norm_correlation_volume",
                "disparity_regression", "regression_topk"),
    "warp": ("disp_warp", "ssim"),
    "misc": ("forward_interpolate", "gauss_blur"),
}
_MODULE = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE)


def __getattr__(name: str):
    if name not in _MODULE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_MODULE[name]}"), name)
