"""Weight bridge between the JAX package's flax trees, reference ``.pth``
checkpoints and the port's modules.

The port's attribute names are the reference's torch names, so a reference
state dict loads as it is. From the flax side, the name rules of
``dkt_stereo_tpu/train/checkpoint.py`` (:29-45 RAFT, :46-62 GWCNet, :63-98
IGEV and CGI, :99-116 PCVNet, which map torch names to flax scopes) are
kept here inverted, flax to torch, a list for each model family.
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
    (r"\.(BatchNorm|GroupNorm)_0\.", "."),
]
_RAFT = [
    (r"(outputs08|outputs16)_(\d+)\.res\.", r"\1.\2.0."),
    (r"(outputs08|outputs16)_(\d+)\.conv\.", r"\1.\2.1."),
    (r"outputs32_(\d+)\.", r"outputs32.\1."),
    (r"(^|\.)mask_conv1\.", r"\1mask.0."),
    (r"(^|\.)mask_conv2\.", r"\1mask.2."),
    # the shared-backbone head Sequential (RAFT and PCVNet)
    (r"^conv2_res\.", "conv2.0."),
    (r"^conv2_out\.", "conv2.1."),
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
# PCVNet: its update block FDM and the reference's Sequential(conv, relu,
# ...) stacks, whose flax scopes carry the Sequential index after an
# underscore
_PCV = _RAFT + [
    (r"^step\.FDM\.", "FDM."),
    (r"(low_level_conv|conv\d_out|conv_softmask|conv_disp)_(\d)\.", r"\1.\2."),
    (r"(^|\.)(conv\d)_(\d)\.", r"\1\2.\3."),
]
# GWCNet: the reference's convbn is Sequential(conv, bn) and its blocks
# Sequential(convbn, ReLU, ...), where the flax tree names conv and bn
_CB = {"conv": "0", "bn": "1"}
_GWC = [
    (r"firstconv_(\d)\.(conv|bn)\.", lambda m: f"firstconv.{2 * int(m[1])}.{_CB[m[2]]}."),
    (r"(layer\d)_(\d+)\.", r"\1.\2."),
    (r"(\.layer\d\.\d+\.conv2)\.(conv|bn)\.", lambda m: f"{m[1]}.{_CB[m[2]]}."),
    (r"(^|\.)(conv[1-4])\.(conv|bn)\.", lambda m: f"{m[1]}{m[2]}.0.{_CB[m[3]]}."),
    (r"downsample_bn\.", "downsample.1."),
    (r"lastconv_0\.(conv|bn)\.", lambda m: f"lastconv.0.{_CB[m[1]]}."),
    (r"lastconv_1\.", "lastconv.2."),
    (r"(dres[01])_(\d)\.(conv|bn)\.", lambda m: f"{m[1]}.{2 * int(m[2])}.{_CB[m[3]]}."),
    (r"(conv[56])_deconv\.", r"\1.0."),
    (r"(conv[56])_bn\.", r"\1.1."),
    (r"(redir[12])\.(conv|bn)\.", lambda m: f"{m[1]}.{_CB[m[2]]}."),
    (r"(classif\d)\.0\.(conv|bn)\.", lambda m: f"{m[1]}.0.{_CB[m[2]]}."),
    (r"(classif\d)\.1\.", r"\1.2."),
    # the ptrans head's Sequential(Linear, BatchNorm1d, ReLU, Linear)
    (r"^projection_(0|3)\.", r"projection.\1."),
    (r"^projection_bn\.", "projection.1."),
]
# CGI-Stereo: the trunk at the top level of the flax tree (feature_trunk),
# FeatUp's modules too (the reference's feature_up), and its Sequentials
_CGI = [
    (r"^feature_trunk\.blocks_(\d)_(\d+)\.",
     lambda m: "feature.block{}.{}.{}.".format(*_IGEV_STAGE[int(m[1])], m[2])),
    (r"^feature_trunk\.", "feature."),
    (r"^(deconv32_16|deconv16_8|deconv8_4|conv4)\.", r"feature_up.\1."),
    (r"^(stem_[24]|spx_4)_bn\.", r"\1.2."),
    (r"^(stem_[24]|spx_4)_(\d)\.", r"\1.\2."),
    (r"^spx_0\.", "spx.0."),
    (r"(^|\.)(semantic|att)_(\d)\.", r"\1\2.\3."),
    (r"(^|\.)(conv[123]|agg_[01])_(\d)\.", r"\1\2.\3."),
]
# the reference registers a ResidualBlock's norm3 twice (also as
# downsample.1), and a BottleneckBlock's norm4, where norm3 is the third
# conv's norm: a block with a conv3 beside its norm3 is a bottleneck
_ALIASES = [(re.compile(r"(^|\.)norm3\.$"), r"\1downsample.1."),
            (re.compile(r"(^|\.)norm4\.$"), r"\1downsample.1.")]
# batch norms the reference creates and never runs (its BasicConv with
# bn=False): no flax state, so they keep BatchNorm's initial values
_UNUSED_BN = re.compile(r"(^|\.)conv1_up\.conv\.weight$")
# CGI's feature.deconv32_16, which the reference builds and never runs: no
# flax state, so zero kernels and BatchNorm's initial values, in the shapes
# of FeatUp's deconv32_16 (the same module)
_CGI_UNUSED = ("feature_up.deconv32_16.", "feature.deconv32_16.")

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}
# flax kernel layout -> torch, by rank: a Dense's (in, out) -> Linear's
# (out, in); HWIO -> OIHW (a depthwise (3, 3, 1, C) -> (C, 1, 3, 3); a
# transposed conv's (k, k, O, I) -> (I, O, k, k)), DHWIO -> OIDHW
_KERNEL_PERM = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _walk(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_scope(scope: tuple, rules) -> str:
    """The torch module prefix (ending in '.') of one flax scope."""
    s = ".".join(scope) + "."
    for pat, repl in rules:
        s = re.sub(pat, repl, s)
    return s


def _torch_scopes(scope: tuple, rules, bottlenecks) -> list[str]:
    """Torch module prefixes of one flax scope, its aliases included.
    ``bottlenecks`` holds the torch prefixes of BottleneckBlocks, whose
    ``norm3`` has no alias."""
    s = _torch_scope(scope, rules)
    if s.endswith("norm3.") and s.removesuffix("norm3.") in bottlenecks:
        return [s]
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


def _rules(scopes: dict, igev: bool | None) -> list:
    if igev or (igev is None and "cost_agg" in scopes):
        return _IGEV
    if {"feature_extraction", "dres0_0", "dres2"} & set(scopes):
        return _GWC
    if {"feature_trunk", "hourglass_fusion"} & set(scopes):
        return _CGI
    return _PCV if _is_pcv(scopes) else _RAFT


def state_dict_from_flax(variables: dict, igev: bool | None = None
                         ) -> "OrderedDict[str, torch.Tensor]":
    """The port's ``state_dict`` from the JAX package's ``{"params",
    "batch_stats"}`` tree of numpy arrays: conv kernels to torch's layout,
    ``scale`` -> ``weight``, ``mean``/``var`` -> ``running_mean``/
    ``running_var``, and a zero ``num_batches_tracked`` per BatchNorm.
    ``igev`` picks IGEV-Stereo's name rules; None tells a whole model's
    tree apart by IGEV's ``cost_agg``. The other families are told apart by
    their own scopes, a whole tree or one of its modules nested at its
    place: GWCNet by ``feature_extraction``, ``dres0_0`` or ``dres2``, CGI by
    ``feature_trunk`` or ``hourglass_fusion``, PCVNet by ``refineNet``,
    ``step.FDM`` or the encoder's ``low_level_conv_0``; else RAFT."""
    scopes = {**variables.get("batch_stats", {}), **variables.get("params", {})}
    rules = _COMMON + _rules(scopes, igev)
    leaves = [item for coll in ("params", "batch_stats") for item in _walk(variables.get(coll, {}))]
    bottlenecks = frozenset(_torch_scope(path[:-1], rules).removesuffix("conv3.")
                            for path, _ in leaves if path[-2:-1] == ("conv3",))
    out: OrderedDict[str, torch.Tensor] = OrderedDict()
    for path, leaf in leaves:
        *scope, name = path
        arr = np.asarray(leaf, dtype=np.float32)
        if name == "kernel":
            arr = arr.transpose(_KERNEL_PERM[arr.ndim])
        for prefix in _torch_scopes(tuple(scope), rules, bottlenecks):
            out[prefix + _LEAF[name]] = torch.tensor(np.ascontiguousarray(arr))
            if name == "mean":
                out[prefix + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    for key in [k for k in out if _UNUSED_BN.search(k)]:
        out.update(_bn_init(key.removesuffix("conv.weight") + "bn.", out[key].shape[1]))
    src, dst = _CGI_UNUSED
    for key in [k for k in out if k.startswith(src) and k.endswith("conv.weight")]:
        out[dst + key.removeprefix(src)] = torch.zeros_like(out[key])
        bn = key.removesuffix("conv.weight") + "bn."
        out.update(_bn_init(dst + bn.removeprefix(src), out[bn + "weight"].shape[0]))
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
