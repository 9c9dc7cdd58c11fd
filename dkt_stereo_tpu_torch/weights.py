"""Weight bridge between the JAX package's flax trees, reference ``.pth``
checkpoints and the port's modules.

The port's attribute names are the reference's torch names, so a reference
state dict loads as it is. From the flax side, the RAFT subset of the name
rules of ``dkt_stereo_tpu/train/checkpoint.py`` (:29-45 and :114-116, which
map torch names to flax scopes) is kept here inverted, flax to torch.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

# flax scope (dot-joined) -> torch module path, applied in order
_FLAX_TO_TORCH: list[tuple[str, str]] = [
    (r"^step\.update_block\.", "update_block."),
    (r"(outputs08|outputs16)_(\d+)\.res\.", r"\1.\2.0."),
    (r"(outputs08|outputs16)_(\d+)\.conv\.", r"\1.\2.1."),
    (r"outputs32_(\d+)\.", r"outputs32.\1."),
    (r"context_zqr_convs_(\d+)\.", r"context_zqr_convs.\1."),
    (r"(^|\.)mask_conv1\.", r"\1mask.0."),
    (r"(^|\.)mask_conv2\.", r"\1mask.2."),
    (r"downsample_conv\.", "downsample.0."),
    (r"\.BatchNorm_0\.", "."),
]
# the reference registers a ResidualBlock's norm3 twice (also as downsample.1)
_ALIASES = [(re.compile(r"(^|\.)norm3\.$"), r"\1downsample.1.")]

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _walk(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_scopes(scope: tuple) -> list[str]:
    """Torch module prefixes (ending in '.') of one flax scope."""
    s = ".".join(scope) + "."
    for pat, repl in _FLAX_TO_TORCH:
        s = re.sub(pat, repl, s)
    return [s] + [pat.sub(repl, s) for pat, repl in _ALIASES if pat.search(s)]


def state_dict_from_flax(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    """The port's ``state_dict`` from the JAX package's ``{"params",
    "batch_stats"}`` tree of numpy arrays: conv kernels HWIO -> OIHW,
    ``scale`` -> ``weight``, ``mean``/``var`` -> ``running_mean``/
    ``running_var``, and a zero ``num_batches_tracked`` per BatchNorm."""
    out: OrderedDict[str, torch.Tensor] = OrderedDict()
    for coll in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(coll, {})):
            *scope, name = path
            arr = np.asarray(leaf, dtype=np.float32)
            if name == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            for prefix in _torch_scopes(tuple(scope)):
                out[prefix + _LEAF[name]] = torch.tensor(np.ascontiguousarray(arr))
                if name == "mean":
                    out[prefix + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return out


def load_reference_pth(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load a reference-format checkpoint (a state dict, possibly nested
    under ``state_dict`` and with DataParallel ``module.`` prefixes) with a
    strict ``load_state_dict``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in state:
        state = state["state_dict"]
    state = {k.removeprefix("module."): v for k, v in state.items()}
    model.load_state_dict(state, strict=True)
    return model
