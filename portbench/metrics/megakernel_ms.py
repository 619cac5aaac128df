"""megakernel_ms.render: device ms a frame in the forward megakernel (B1,
``ops/cuda_wavefront.trace_megakernel`` -> ``csrc/wavefront.cu``), by its
kernels' names in the trace."""

SOURCE = "device_trace"
UNIT = "ms"
KERNELS = r"forward_brute_kernel|wavefront_kernel<0\b"


def read(run):
    s = run.trace.device_s(KERNELS)
    return s * 1e3 / len(run.spans) if s > 0 else None
