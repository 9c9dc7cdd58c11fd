"""State-dict manifest of timm ``mobilenetv2_100``: the port's copy of
``dkt_stereo_tpu/nn/mobilenetv2_manifest.py``.

The reference builds IGEV's trunk with ``timm.create_model('mobilenetv2_100',
pretrained=True, features_only=True)`` (meta_arch/igev_stereo/extractor.py:330).
The checkpoint's key and shape contract, from the public MobileNetV2
architecture table (Sandler et al. 2018, Table 2) under timm's names
(``conv_stem``/``bn1``; ``blocks.S.B`` with ``conv_dw``/``conv_pw``
[/``conv_pwl``] and ``bn1``/``bn2`` [/``bn3``]), is what
``train/checkpoint.py::import_timm_mobilenetv2`` holds a raw checkpoint to.

Shapes are torch's: conv (O, I, kH, kW), depthwise (C, 1, 3, 3); batch-norm
vectors (C,), and the scalar ``num_batches_tracked``.
"""

from __future__ import annotations

# (expansion t, out channels c, repeats n, first stride s) — MNV2-1.0
STAGES = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def _bn(prefix: str, c: int) -> dict:
    return {
        f"{prefix}.weight": (c,),
        f"{prefix}.bias": (c,),
        f"{prefix}.running_mean": (c,),
        f"{prefix}.running_var": (c,),
        f"{prefix}.num_batches_tracked": (),
    }


def timm_mobilenetv2_100_manifest() -> dict:
    """key -> torch shape for the features_only=True state dict (the full
    ImageNet checkpoint additionally has conv_head/bn2/classifier, which the
    loader ignores)."""
    keys = {"conv_stem.weight": (32, 3, 3, 3)}
    keys.update(_bn("bn1", 32))
    cin = 32
    for si, (t, c, n, _s) in enumerate(STAGES):
        for j in range(n):
            p = f"blocks.{si}.{j}"
            if t == 1:  # DepthwiseSeparableConv (stage 0)
                keys[f"{p}.conv_dw.weight"] = (cin, 1, 3, 3)
                keys.update(_bn(f"{p}.bn1", cin))
                keys[f"{p}.conv_pw.weight"] = (c, cin, 1, 1)
                keys.update(_bn(f"{p}.bn2", c))
            else:  # InvertedResidual
                mid = cin * t
                keys[f"{p}.conv_pw.weight"] = (mid, cin, 1, 1)
                keys.update(_bn(f"{p}.bn1", mid))
                keys[f"{p}.conv_dw.weight"] = (mid, 1, 3, 3)
                keys.update(_bn(f"{p}.bn2", mid))
                keys[f"{p}.conv_pwl.weight"] = (c, mid, 1, 1)
                keys.update(_bn(f"{p}.bn3", c))
            cin = c
    return keys


# full-checkpoint classifier head, absent under features_only — tolerated
# and ignored by the loader
HEAD_KEY_PREFIXES = ("conv_head.", "bn2.", "classifier.")
