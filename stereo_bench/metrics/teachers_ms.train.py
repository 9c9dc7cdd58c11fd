"""Mean device ms a step of the two teachers' forwards: CUDA events at the
step's ``mark("ema")`` and ``mark("teachers")``, over the window's steps."""

import numpy as np


def read(rec):
    ms = rec.get("parts_ms", {}).get("teachers")
    return float(np.mean(ms)) if ms else None
