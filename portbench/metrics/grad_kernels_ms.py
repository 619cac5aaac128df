"""grad_kernels_ms.grad: device ms a step in the gradient kernels: the
product tier's stash-writing forward and reverse sweep (B2
``wavefront_kernel<1>``, B3 ``wavefront_grad_rev_kernel``), the pathwise
tier's (B5a ``wavefront_kernel<2>``, B5b), or the fused kernel (B4
``wavefront_grad_fused_kernel``), by their names in the trace."""

SOURCE = "device_trace"
UNIT = "ms"
KERNELS = (r"wavefront_kernel<[124]\b|wavefront_grad_rev_kernel|wavefront_grad_rev_pathwise"
           r"|wavefront_grad_fused_kernel")


def read(run):
    s = run.trace.device_s(KERNELS)
    return s * 1e3 / len(run.spans) if s > 0 else None
