"""Mean host ms a request inside the program's forward call (its dispatch;
the device runs behind it), over the window's requests, a frame (a request of B pairs counts B)."""

import numpy as np


def read(rec):
    spans = rec.get("spans", {}).get("forward")
    return 1e3 * float(np.mean(spans)) / rec["frames_per_unit"] if spans else None
