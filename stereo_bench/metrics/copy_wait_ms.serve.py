"""Mean host ms a request from the forward's return until its disparity is
on the host (unpad and the copy back, which waits for the device), over the
window's requests."""

import numpy as np


def read(rec):
    spans = rec.get("spans", {}).get("copy_wait")
    return 1e3 * float(np.mean(spans)) / rec["frames_per_unit"] if spans else None
