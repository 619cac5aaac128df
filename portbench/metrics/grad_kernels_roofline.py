"""grad_kernels_roofline.grad: the gradient kernels' share of their
bound, in %: what enters and leaves the layer's function (rays, the
cotangent, tables, environment texels and sample rows in; radiance and
gradients out; ``roofline.grad_kernels_bytes``, which leaves out the
stash between the forward and the reverse sweep and the miss rows) at the
card's peak bandwidth, over their device time in the same steps.  The
launches counted are the layer's last kernel's (B3, B5b or B4)."""

from portbench import roofline
from portbench.metrics.grad_kernels_ms import KERNELS

SOURCE = "device_trace"
UNIT = "%"
LAST = r"wavefront_grad_rev_kernel|wavefront_grad_rev_pathwise|wavefront_grad_fused_kernel"


def read(run):
    launches = run.trace.kernels(LAST)
    if not launches:
        return None
    moved = roofline.grad_kernels_bytes(run.config, run.sky, run.rays_per_call * len(run.spans),
                                        len(launches))
    return roofline.share_pct(moved, run.trace.device_s(KERNELS))
