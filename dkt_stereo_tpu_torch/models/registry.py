"""Name -> (model class, config class) registry
(``dkt_stereo_tpu/models/registry.py``) with :func:`register_model`, the
model factory and the loss adapter of the DKT step.

The five model families of the JAX registry are registered here, ported
in test and train mode: RAFTStereo, IGEVStereo, PCVNet, GWCNet and
CGI_Stereo, with their ``sequence_loss_raft``, ``sequence_loss_igev``,
``sequence_loss_pcvnet``, ``loss_gwcnet`` and ``loss_cgi``. ``ns_loss`` is
not a loss of this interface: it takes the trinocular batch, and
``train/ns_step.py`` calls it."""

from __future__ import annotations

import time

import torch

from dkt_stereo_tpu_torch.device import resolve_device
from dkt_stereo_tpu_torch.losses.cgi import loss_cgi
from dkt_stereo_tpu_torch.losses.gwc import loss_gwcnet
from dkt_stereo_tpu_torch.losses.pcv import sequence_loss_pcvnet
from dkt_stereo_tpu_torch.losses.sequence import sequence_loss_igev, sequence_loss_raft
from dkt_stereo_tpu_torch.models.cgi_stereo import CGIStereo, CGIStereoConfig
from dkt_stereo_tpu_torch.models.gwcnet import GWCNet, GWCNetConfig
from dkt_stereo_tpu_torch.models.igev_stereo import IGEVStereo, IGEVStereoConfig
from dkt_stereo_tpu_torch.models.pcvnet import PCVNet, PCVNetConfig
from dkt_stereo_tpu_torch.models.raft_stereo import RAFTStereo, RAFTStereoConfig

MODELS: dict[str, tuple] = {}
# each registered model's loss function, and the name of its loss in the
# reference's ``__losses__`` (meta_arch/__init__.py:15-21) where it has one
LOSSES: dict = {}
DEFAULT_LOSS: dict[str, str] = {}
_LOSS_NAMES = ("sequence_loss_raft", "sequence_loss_igev", "sequence_loss_pcvnet",
               "loss_gwcnet", "loss_cgi")


def register_model(name: str, model_cls, config_cls, loss_fn):
    """Register a model family under ``name`` (the JAX registry's
    ``register_model``): :func:`get_model` then returns ``(model_cls,
    config_cls)``, :func:`create_model` builds it from a config whose
    ``"model"`` is ``name`` (as ``model_cls(config_cls.from_dict(config),
    iters=..., test_mode=...)``), and :func:`make_loss_adapter` takes
    ``loss_fn`` as its default loss: by the reference's name where
    ``loss_fn`` is one of the port's losses, else called as
    ``loss_fn(outputs, flow_gt, valid)`` for ``(loss, metrics, mask, ok)``.
    Returns ``model_cls``."""
    MODELS[name] = (model_cls, config_cls)
    LOSSES[name] = loss_fn
    if getattr(loss_fn, "__name__", None) in _LOSS_NAMES:
        DEFAULT_LOSS[name] = loss_fn.__name__
    else:
        DEFAULT_LOSS.pop(name, None)
    return model_cls


def get_model(name: str):
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(MODELS)}")
    return MODELS[name]


register_model("RAFTStereo", RAFTStereo, RAFTStereoConfig, sequence_loss_raft)
register_model("IGEVStereo", IGEVStereo, IGEVStereoConfig, sequence_loss_igev)
register_model("PCVNet", PCVNet, PCVNetConfig, sequence_loss_pcvnet)
register_model("GWCNet", GWCNet, GWCNetConfig, loss_gwcnet)
register_model("CGI_Stereo", CGIStereo, CGIStereoConfig, loss_cgi)


def init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Seeded random init: kaiming-normal fan-out weights for every 2-D and
    3-D conv and transposed conv, and zero biases (core/extractor.py:155-162,
    the JAX package's ``kaiming_out`` / ``he_3d``); norms keep their
    identity init. The fan-out is ``weight.shape[0]`` times the kernel's
    size, as torch's ``kaiming_normal_(mode="fan_out")`` counts it: the
    output channels of a conv (a depthwise conv included), the input
    channels of a transposed conv, which is also what the JAX initializer
    counts on that conv's (k, k, O, I) kernel."""
    convs = (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.ConvTranspose2d, torch.nn.ConvTranspose3d)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, convs):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


def create_model(config: dict, iters: int = 32, device=None, seed: int | None = None,
                 test_mode: bool = True):
    """Build the model a config dict names on ``device`` (the GPU unless
    ``device="cpu"`` is passed): in eval mode for ``test_mode``, else in
    train mode. ``seed`` draws random weights from a ``torch.Generator``;
    otherwise they are left to be loaded (``weights.load_reference_pth``).
    ``create_model.seconds`` sums the host seconds of every call: the
    construction with PyTorch's default init, the seeded init, the move."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    model_cls, cfg_cls = get_model(config["model"])
    model = model_cls(cfg_cls.from_dict(config), iters=iters, test_mode=test_mode)
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(dev).train(not test_mode)
    create_model.seconds += time.perf_counter() - t0
    return model


create_model.seconds = 0.0


def make_loss_adapter(name: str, cfg: dict | None = None, loss_func: str | None = None):
    """The DKT step's loss interface, ``fn(outputs, flow_gt, valid) -> (loss,
    metrics, mask, ok)`` (``dkt_stereo_tpu/models/registry.py:43-79``).
    ``cfg`` is the model's config dict (IGEV's loss reads ``max_disp``,
    GWCNet's and CGI's ``maxdisp``, 192 without one); ``loss_func`` picks the loss by its reference name;
    None takes the model's default (for a model registered with a loss of
    its own, that loss). ``ns_loss`` raises a ValueError that
    points at the NS route; an unknown name a KeyError."""
    get_model(name)
    if loss_func is None and name not in DEFAULT_LOSS:
        return LOSSES[name]
    loss_func = loss_func or DEFAULT_LOSS[name]
    if loss_func == "sequence_loss_raft":
        return lambda out, gt, v: sequence_loss_raft(out["disp_preds"], gt, v)
    if loss_func == "sequence_loss_igev":
        cfg = cfg or {}
        max_disp = cfg.get("max_disp", cfg.get("maxdisp", 192))
        return lambda out, gt, v: sequence_loss_igev(out["disp_preds"], out["init_disp"], gt, v,
                                                     max_disp=max_disp)
    if loss_func == "sequence_loss_pcvnet":
        return lambda out, gt, v: sequence_loss_pcvnet(out["output_list"], gt, v)
    if loss_func in ("loss_gwcnet", "loss_cgi"):
        loss = loss_gwcnet if loss_func == "loss_gwcnet" else loss_cgi
        maxdisp = (cfg or {}).get("maxdisp", 192)
        return lambda out, gt, v: loss(out["disp_preds"], gt, v, maxdisp)
    if loss_func == "ns_loss":
        # the trinocular batch (conf, im0/im1/im2) is not this interface's
        # (outputs, gt, valid); the reference registers ns_loss with the
        # same mismatch against ft_dkt.py:227's call
        raise ValueError(
            "ns_loss requires the trinocular batch contract; select it via a config with "
            "loss_func='ns_loss' and --train_datasets nerf_stereo (cli/train.py routes that "
            "to the NeRF-Stereo training step)")
    raise KeyError(f"unknown loss_func {loss_func!r}; ported: ['loss_cgi', 'loss_gwcnet', "
                   "'sequence_loss_igev', 'sequence_loss_pcvnet', 'sequence_loss_raft']")
