"""env_shade_ms.render: device ms a frame in the deferred miss shader
(``integrator/wavefront._add_miss``: the environment's bilinear texels of
every ray that left the scene, the phantom rule, the miss term added to
the radiance), read inside its range."""

SOURCE = "device_trace"
UNIT = "ms"
RANGES = {"env_shade": "go_raytracing_tpu_torch.integrator.wavefront:_add_miss"}


def read(run):
    s = run.trace.device_s(in_range="env_shade")
    return s * 1e3 / len(run.spans) if s > 0 else None
