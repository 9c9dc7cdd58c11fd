"""Checkpoints of the port: torch-native save and resume of a DKT run
(``dkt_stereo_tpu/train/checkpoint.py:484-535``), reference ``.pth`` state
dicts, and timm's MobileNetV2 weights for IGEV's and CGI's trunk (:286-382).

A port checkpoint is a directory ``save_dir/step_N`` holding one file,
``dkt_state.pt``: a ``torch.save`` of ``{"step", "student", "ema",
"teacher", "optimizer"}``, the three models' state dicts and
``optimizer.state_dict()``. The optimizer's state carries AdamW's own step
count, which is the schedule's position (``train/state.py``), so a restore
resumes the schedule too. The directory is written under a temporary name
and renamed into place, so an interrupted save never looks complete, and
:func:`latest_checkpoint` matches ``step_N`` names only. The name keeps the
recipes' paths (``$workspace/stage1/step_5000``) valid.

A JAX package checkpoint (an Orbax directory) is told apart by its contents
and refused: ``python -m dkt_stereo_tpu.cli.export`` turns it into a
reference ``.pth``, which the port reads.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from dkt_stereo_tpu_torch.nn.mobilenetv2_manifest import (
    HEAD_KEY_PREFIXES,
    timm_mobilenetv2_100_manifest,
)
from dkt_stereo_tpu_torch.train.state import DKTTrainState
from dkt_stereo_tpu_torch.weights import _IGEV_STAGE, reference_state_dict

CHECKPOINT_FILE = "dkt_state.pt"
WEIGHT_SETS = ("student", "ema", "teacher")
# what an Orbax checkpoint directory of the JAX package holds
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt", "checkpoint")


def save_checkpoint(save_dir, state: DKTTrainState, step: int | None = None) -> str:
    """Write ``save_dir/step_N`` (N = ``step``, else ``state.step``) and
    return its path. The step stored inside is ``state.step``."""
    save_dir = Path(save_dir).absolute()
    save_dir.mkdir(parents=True, exist_ok=True)
    final = save_dir / f"step_{state.step if step is None else step}"
    tmp = Path(tempfile.mkdtemp(prefix=f".{final.name}.tmp-", dir=save_dir))
    try:
        torch.save({"step": int(state.step),
                    **{w: getattr(state, w).state_dict() for w in WEIGHT_SETS},
                    "optimizer": state.optimizer.state_dict()}, tmp / CHECKPOINT_FILE)
        if final.exists():  # a save of the same step again replaces it
            old = Path(tempfile.mkdtemp(prefix=f".{final.name}.old-", dir=save_dir))
            os.replace(final, old / final.name)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp)
    return str(final)


def _load(path) -> dict:
    """The contents of a port checkpoint directory; a JAX package (Orbax)
    checkpoint or any other path raises, saying what it is."""
    path = Path(path)
    file = path / CHECKPOINT_FILE
    if file.is_file():
        return torch.load(file, map_location="cpu", weights_only=True)
    if path.is_dir() and any((path / m).exists() for m in _ORBAX_MARKERS):
        raise ValueError(
            f"{str(path)!r} is a checkpoint of the JAX package (Orbax), which the port does not "
            "read: convert it to a reference .pth with `python -m dkt_stereo_tpu.cli.export "
            "--restore_ckpt <it> --template <the .pth it started from> --out <x.pth>`")
    raise FileNotFoundError(f"{str(path)!r} is neither a port checkpoint (a step_N directory "
                            f"with {CHECKPOINT_FILE}) nor a reference .pth")


def restore_checkpoint(path, state: DKTTrainState, weights_only: bool = False) -> DKTTrainState:
    """Load a port checkpoint into ``state`` in place and return it: the
    student, EMA and teacher weights, and unless ``weights_only`` also the
    step and the optimizer state (with it the schedule's position).
    ``weights_only`` is the recipes' stage 2: step 0, a fresh optimizer and
    schedule, the stage-1 weights."""
    ckpt = _load(path)
    for w in WEIGHT_SETS:
        getattr(state, w).load_state_dict(ckpt[w], strict=True)
    if not weights_only:
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
    return state


def restore_variables(path, which: str = "student") -> dict:
    """The state dict of one weight set from any checkpoint the port reads:
    a reference ``.pth`` (its state dict; ``which`` does not apply) or a port
    checkpoint (``which`` is ``student``, ``ema`` or ``teacher``)."""
    if os.fspath(path).endswith(".pth"):
        return reference_state_dict(path)
    if which not in WEIGHT_SETS:
        raise ValueError(f"which={which!r}: one of {WEIGHT_SETS}")
    return _load(path)[which]


def latest_checkpoint(save_dir) -> str | None:
    """The newest ``step_N`` directory under ``save_dir``, or None. Temporary
    directories of a save in progress and stray files do not match."""
    best, best_step = None, -1
    for p in Path(save_dir).glob("step_*"):
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and p.is_dir() and int(m.group(1)) > best_step:
            best_step, best = int(m.group(1)), str(p)
    return best


def _timm_to_igev(key: str) -> str:
    """timm ``mobilenetv2_100`` name -> the port's trunk name (IGEV's and
    CGI's, both the reference's ``feature.``)."""
    if key.startswith("blocks."):
        _, stage, block, rest = key.split(".", 3)
        group, index = _IGEV_STAGE[int(stage)]
        return f"feature.block{group}.{index}.{block}.{rest}"
    return f"feature.{key}"


def import_timm_mobilenetv2(path_or_state, model: torch.nn.Module) -> dict:
    """``model``'s state dict with its MobileNetV2 trunk (IGEV's or CGI's
    ``feature.conv_stem``, ``bn1``, ``block0..4``) taken from a raw timm
    ``mobilenetv2_100`` checkpoint: the ImageNet-pretrained trunk the
    reference gets from ``timm.create_model(..., pretrained=True)``
    (meta_arch/igev_stereo/extractor.py:330, meta_arch/cgi/CGI_Stereo.py:44).
    Takes a ``.pth`` or ``.npz``
    path or a dict of tensors or arrays.

    Strict against the manifest (``nn/mobilenetv2_manifest.py``): every
    tensor of stages 0-5 and the stem must be there with the manifest's
    shape, and every trunk weight and running statistic of ``model`` must be
    filled; stage 6, the classifier head and the ``num_batches_tracked``
    counters are ignored, as the JAX importer ignores them (the reference
    slices ``model.blocks[0:6]``, extractor.py:338-342)."""
    if isinstance(path_or_state, (str, os.PathLike)):
        p = os.fspath(path_or_state)
        if p.endswith(".npz"):
            with np.load(p) as z:
                state = {k: z[k] for k in z.files}
        else:
            state = reference_state_dict(p)
    else:
        state = path_or_state

    manifest = timm_mobilenetv2_100_manifest()
    needed = [k for k in manifest
              if not k.startswith("blocks.6.") and not k.endswith("num_batches_tracked")]
    missing = sorted(set(needed) - set(state))
    if missing:
        raise ValueError(f"checkpoint is missing mobilenetv2 tensors: {missing[:10]}")

    out = {k: v.clone() for k, v in model.state_dict().items()}
    placed = set()
    for key, tensor in state.items():
        if (key.startswith(HEAD_KEY_PREFIXES) or key.startswith("blocks.6.")
                or key.endswith("num_batches_tracked")):
            continue
        value = torch.as_tensor(tensor)
        if key in manifest and tuple(value.shape) != tuple(manifest[key]):
            raise ValueError(f"{key}: shape {tuple(value.shape)} != manifest {manifest[key]}")
        name = _timm_to_igev(key)
        if name not in out or out[name].shape != value.shape:
            raise ValueError(f"cannot place mobilenetv2 tensor {key} (as {name})")
        out[name] = value.to(out[name].dtype).clone()
        placed.add(name)
    trunk = [k for k in out if k.startswith(("feature.conv_stem.", "feature.bn1.",
                                             "feature.block"))
             and not k.endswith("num_batches_tracked")]
    unfilled = [k for k in trunk if k not in placed]
    if not trunk or unfilled:
        raise ValueError("model has no MobileNetV2 trunk" if not trunk else
                         f"trunk tensors not covered by the checkpoint: {unfilled[:10]}")
    return out
