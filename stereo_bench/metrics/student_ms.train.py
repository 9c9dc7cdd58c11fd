"""Mean device ms a step of the student's forward and backward: CUDA events
at the step's ``mark("fande")`` and ``mark("student")``, over the window's
steps."""

import numpy as np


def read(rec):
    ms = rec.get("parts_ms", {}).get("student")
    return float(np.mean(ms)) if ms else None
