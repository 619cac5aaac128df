"""megakernel_roofline.render: the forward megakernel's (B1's) share of
its bound, in %: the bytes of its rays in, its radiance out, the
environment's sample rows, and the scene tables and environment texels
once a launch (``roofline.megakernel_bytes``) at the card's peak
bandwidth, over B1's device time in the same frames."""

from portbench import roofline
from portbench.metrics.megakernel_ms import KERNELS

SOURCE = "device_trace"
UNIT = "%"


def read(run):
    launches = run.trace.kernels(KERNELS)
    if not launches:
        return None
    moved = roofline.megakernel_bytes(run.config, run.sky, run.rays_per_call * len(run.spans),
                                      len(launches))
    return roofline.share_pct(moved, run.trace.device_s(KERNELS))
