"""Name -> (model class, config class) registry
(``dkt_stereo_tpu/models/registry.py``) and the model factory.

Only RAFTStereo is ported; the other names of the JAX registry raise a
KeyError naming their ROADMAP.md queue entry."""

from __future__ import annotations

import torch

from dkt_stereo_tpu_torch.device import resolve_device
from dkt_stereo_tpu_torch.models.raft_stereo import RAFTStereo, RAFTStereoConfig

MODELS: dict[str, tuple] = {"RAFTStereo": (RAFTStereo, RAFTStereoConfig)}

_QUEUED = {
    "IGEVStereo": "Queue 1 item 7",
    "PCVNet": "Queue 1 item 8",
    "GWCNet": "Queue 1 item 9",
    "CGI_Stereo": "Queue 1 item 9",
}


def get_model(name: str):
    if name not in MODELS:
        where = _QUEUED.get(name)
        if where is not None:
            raise KeyError(f"model {name!r} is not ported yet: ROADMAP.md {where}")
        raise KeyError(f"unknown model {name!r}; ported: {sorted(MODELS)}")
    return MODELS[name]


def init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Seeded random init: kaiming-normal fan-out conv weights and zero
    biases (core/extractor.py:155-162, the JAX package's ``kaiming_out``);
    norms keep their identity init."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


def create_model(config: dict, iters: int = 32, device=None, seed: int | None = None):
    """Build the model a config dict names, in eval mode, on ``device``
    (the GPU unless ``device="cpu"`` is passed). ``seed`` draws random
    weights from a ``torch.Generator``; otherwise they are left to be
    loaded (``weights.load_reference_pth``)."""
    dev = resolve_device(device)
    model_cls, cfg_cls = get_model(config["model"])
    model = model_cls(cfg_cls.from_dict(config), iters=iters, test_mode=True)
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
