"""The 95th percentile over every request of the window of its latency,
from handing the pair to the port until its disparity is on the host, in
ms (host clock)."""

import numpy as np


def read(rec):
    lat = rec.get("latencies_s")
    return 1e3 * float(np.percentile(lat, 95)) if "frames" in rec and lat else None
