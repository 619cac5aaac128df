"""raygen_ms.<render|grad>: device ms a frame or step in ray generation,
the kernels launched inside ``render/renderer._chunk_rays`` (the pixel ids,
``camera.generate_rays`` and its int64 PCG3D draws in ``core/rng``)."""

SOURCE = "device_trace"
UNIT = "ms"
RANGES = {"raygen": "go_raytracing_tpu_torch.render.renderer:_chunk_rays"}


def read(run):
    s = run.trace.device_s(in_range="raygen")
    return s * 1e3 / len(run.spans) if s > 0 else None
