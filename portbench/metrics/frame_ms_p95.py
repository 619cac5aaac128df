"""frame_ms_p95: the 95th percentile of the frames' host times in the
window, each from the call until the picture is on the host, in ms
(numpy's linear interpolation between order statistics)."""

import numpy as np

SOURCE = "host_clock"
UNIT = "ms"


def read(run):
    return float(np.percentile([(b - a) * 1e3 for a, b in run.spans], 95))
