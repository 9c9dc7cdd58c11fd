"""Host seconds of set-up in the first load of each of the program's CUDA
kernels (the nvcc build on a checkout's first run, and the ``dlopen``):
the program's counter ``ops/cuda/_build.py::load.seconds``, 0 where no
kernel was loaded."""


def read(rec):
    try:
        from dkt_stereo_tpu_torch.ops.cuda._build import load
    except ImportError:
        return None
    return getattr(load, "seconds", None)
