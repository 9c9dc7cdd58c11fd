"""Weight bridge between the JAX package's flax trees, reference ``.pth``
checkpoints and the port's modules.

The port's attribute names are the reference's torch names, so a reference
state dict loads as it is. From the flax side, the RAFT, IGEV and PCVNet
subsets of the name rules of ``dkt_stereo_tpu/train/checkpoint.py`` (:29-45,
:63-92, :99-111 and :114-116, which map torch names to flax scopes) are kept
here inverted, flax to torch.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from collections.abc import Mapping

import numpy as np
import torch

# flax scope (dot-joined) -> torch module path, applied in order; shared by
# the models
_COMMON: list[tuple] = [
    (r"^step\.update_block\.", "update_block."),
    (r"context_zqr_convs_(\d+)\.", r"context_zqr_convs.\1."),
    (r"downsample_conv\.", "downsample.0."),
    (r"\.BatchNorm_0\.", "."),
]
_RAFT = [
    (r"(outputs08|outputs16)_(\d+)\.res\.", r"\1.\2.0."),
    (r"(outputs08|outputs16)_(\d+)\.conv\.", r"\1.\2.1."),
    (r"outputs32_(\d+)\.", r"outputs32.\1."),
    (r"(^|\.)mask_conv1\.", r"\1mask.0."),
    (r"(^|\.)mask_conv2\.", r"\1mask.2."),
]
# IGEV's encoder names its heads by true scale (outputs04/08/16) where the
# flax tree keeps RAFT's scale-indexed names
_IGEV_HEAD = {"08": "04", "16": "08"}
_HEAD_PART = {"res": "0", "conv": "1"}
# timm stage -> (the reference's feature.blockN, index inside it)
_IGEV_STAGE = {0: (0, 0), 1: (1, 0), 2: (2, 0), 3: (3, 0), 4: (3, 1), 5: (4, 0)}
_IGEV = [
    (r"outputs(08|16)_(\d+)\.(res|conv)\.",
     lambda m: f"outputs{_IGEV_HEAD[m[1]]}.{m[2]}.{_HEAD_PART[m[3]]}."),
    (r"outputs32_(\d+)\.", r"outputs16.\1."),
    (r"^feature\.trunk\.blocks_(\d)_(\d+)\.",
     lambda m: "feature.block{}.{}.{}.".format(*_IGEV_STAGE[int(m[1])], m[2])),
    (r"^feature\.trunk\.", "feature."),
    (r"^(stem_[24])_(\d)\.", r"\1.\2."),
    (r"^spx_4_(\d)\.", r"spx_4.\1."),
    (r"^spx_0\.", "spx.0."),
    (r"^step\.spx_gru_0\.", "spx_gru.0."),
    (r"^step\.spx_2_gru\.", "spx_2_gru."),
    (r"feat_att_(\d)\.", r"feat_att.\1."),
    (r"(^|\.)(conv[123]|agg_[01])_(\d)\.", r"\1\2.\3."),
    (r"mask_feat_4_0\.", "mask_feat_4.0."),
]
# PCVNet: its update block FDM, the shared-backbone head conv2 (a
# ResidualBlock and a conv) and the reference's Sequential(conv, relu, ...)
# stacks, whose flax scopes carry the Sequential index after an underscore
_PCV = _RAFT + [
    (r"^step\.FDM\.", "FDM."),
    (r"^conv2_res\.", "conv2.0."),
    (r"^conv2_out\.", "conv2.1."),
    (r"(low_level_conv|conv\d_out|conv_softmask|conv_disp)_(\d)\.", r"\1.\2."),
    (r"(^|\.)(conv\d)_(\d)\.", r"\1\2.\3."),
]
# the reference registers a ResidualBlock's norm3 twice (also as downsample.1)
_ALIASES = [(re.compile(r"(^|\.)norm3\.$"), r"\1downsample.1.")]
# batch norms the reference creates and never runs (its BasicConv with
# bn=False): no flax state, so they keep BatchNorm's initial values
_UNUSED_BN = re.compile(r"(^|\.)conv1_up\.conv\.weight$")

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}
# flax kernel layout -> torch, by rank: HWIO -> OIHW (a depthwise (3, 3, 1,
# C) -> (C, 1, 3, 3); a transposed conv's (k, k, O, I) -> (I, O, k, k)),
# DHWIO -> OIDHW
_KERNEL_PERM = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _walk(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_scopes(scope: tuple, rules) -> list[str]:
    """Torch module prefixes (ending in '.') of one flax scope."""
    s = ".".join(scope) + "."
    for pat, repl in rules:
        s = re.sub(pat, repl, s)
    return [s] + [pat.sub(repl, s) for pat, repl in _ALIASES if pat.search(s)]


def _bn_init(prefix: str, channels: int) -> dict:
    return {prefix + "weight": torch.ones(channels), prefix + "bias": torch.zeros(channels),
            prefix + "running_mean": torch.zeros(channels),
            prefix + "running_var": torch.ones(channels),
            prefix + "num_batches_tracked": torch.tensor(0, dtype=torch.long)}


def _is_pcv(params: dict) -> bool:
    """A PCVNet tree, or one of its modules nested at its place: the
    refinement net, the update block or the encoder's low-level head."""
    return ("refineNet" in params or "FDM" in params.get("step", {})
            or "low_level_conv_0" in params.get("cnet", {}))


def state_dict_from_flax(variables: dict, igev: bool | None = None
                         ) -> "OrderedDict[str, torch.Tensor]":
    """The port's ``state_dict`` from the JAX package's ``{"params",
    "batch_stats"}`` tree of numpy arrays: conv kernels to torch's layout,
    ``scale`` -> ``weight``, ``mean``/``var`` -> ``running_mean``/
    ``running_var``, and a zero ``num_batches_tracked`` per BatchNorm.
    ``igev`` picks IGEV-Stereo's name rules over RAFT-Stereo's; None tells
    a whole model's tree apart by IGEV's ``cost_agg``. A PCVNet tree is told
    apart by its own scopes (``refineNet``, ``step.FDM``, the encoder's
    ``low_level_conv_0``)."""
    params = variables.get("params", {})
    if igev is None:
        igev = "cost_agg" in params
    rules = _COMMON + (_IGEV if igev else _PCV if _is_pcv(params) else _RAFT)
    out: OrderedDict[str, torch.Tensor] = OrderedDict()
    for coll in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(coll, {})):
            *scope, name = path
            arr = np.asarray(leaf, dtype=np.float32)
            if name == "kernel":
                arr = arr.transpose(_KERNEL_PERM[arr.ndim])
            for prefix in _torch_scopes(tuple(scope), rules):
                out[prefix + _LEAF[name]] = torch.tensor(np.ascontiguousarray(arr))
                if name == "mean":
                    out[prefix + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    for key in [k for k in out if _UNUSED_BN.search(k)]:
        out.update(_bn_init(key.removesuffix("conv.weight") + "bn.", out[key].shape[1]))
    return out


def dkt_state_from_flax(state) -> dict:
    """The port's student, EMA and teacher state dicts from a JAX
    ``DKTTrainState`` whose leaves are numpy arrays (``params``,
    ``ema_params``, ``teacher_params``), each through
    :func:`state_dict_from_flax`. The optimizer state is not carried over."""
    return {
        "student": state_dict_from_flax(state.params),
        "ema": state_dict_from_flax(state.ema_params),
        "teacher": state_dict_from_flax(state.teacher_params),
    }


def reference_state_dict(path) -> dict:
    """A reference-format ``.pth`` as a plain state dict: nested under
    ``state_dict`` or not, DataParallel ``module.`` prefixes removed."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in state:
        state = state["state_dict"]
    return {k.removeprefix("module."): v for k, v in state.items()}


def load_reference_pth(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load a reference-format checkpoint (a state dict, possibly nested
    under ``state_dict`` and with DataParallel ``module.`` prefixes) with a
    strict ``load_state_dict``."""
    model.load_state_dict(reference_state_dict(path), strict=True)
    return model
