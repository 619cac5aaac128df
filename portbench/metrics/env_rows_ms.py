"""env_rows_ms.<render|grad>: device ms a frame or step drawing the
environment's NEE samples in torch (``ops/cuda_wavefront.hdri_rows_for``:
the alias table's picks, directions, texels and pdfs of every bounce,
``lights/hdri``)."""

SOURCE = "device_trace"
UNIT = "ms"
RANGES = {"env_rows": "go_raytracing_tpu_torch.ops.cuda_wavefront:hdri_rows_for"}


def read(run):
    s = run.trace.device_s(in_range="env_rows")
    return s * 1e3 / len(run.spans) if s > 0 else None
