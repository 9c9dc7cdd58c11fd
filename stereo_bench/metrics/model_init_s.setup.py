"""Host seconds of set-up in building the program's models (construction
with PyTorch's default init, the move to the device): the program's
counter ``models/registry.py::create_model.seconds``, over every call (a
frame cell makes one model, a DKT cell three)."""


def read(rec):
    try:
        from dkt_stereo_tpu_torch.models.registry import create_model
    except ImportError:
        return None
    return getattr(create_model, "seconds", None)
