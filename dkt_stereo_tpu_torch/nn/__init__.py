"""Neural-net building blocks (``dkt_stereo_tpu/nn``), exported by name as
the JAX package exports them. Module attribute names are the reference's
torch names, so its ``.pth`` checkpoints load with a strict
``load_state_dict``. A name's module is imported at its first use (PEP
562), so importing one module of the package does not import the others."""

from __future__ import annotations

import importlib

_EXPORTS = {
    "norms": ("Norm",),
    "blocks": ("BasicEncoder", "BottleneckBlock", "MultiBasicEncoder", "ResidualBlock"),
    "gru": ("BasicMotionEncoder", "BasicMultiUpdateBlock", "ConvGRU", "FlowHead", "SepConvGRU"),
}
_MODULE = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE)


def __getattr__(name: str):
    if name not in _MODULE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_MODULE[name]}"), name)
