"""The program's kernel launch counters: every function of the
``dkt_stereo_tpu_torch.ops.cuda`` modules that carries an integer
``launches`` attribute, by its name. A kernel that a later change adds is
found the same way."""

from __future__ import annotations

import importlib
import pkgutil


def read() -> dict:
    import dkt_stereo_tpu_torch.ops.cuda as pkg

    out = {}
    for info in pkgutil.iter_modules(pkg.__path__):
        if info.name.startswith("_"):
            continue
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for name, obj in vars(mod).items():
            n = getattr(obj, "launches", None)
            own = getattr(obj, "__module__", "") == mod.__name__
            if callable(obj) and isinstance(n, int) and own:
                out[name] = n
    return out


def diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}
