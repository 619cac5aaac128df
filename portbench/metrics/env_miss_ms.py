"""env_miss_ms.grad: device ms a step in the environment's miss terms and
texel sums: ``ops/cuda_wavefront._env_miss_terms`` (the miss colour, the
miss direction's cotangent by autograd, the miss texels' sums) and the
per-texel sums of the fused kernel's sample cotangents
(``core/segsum.cols_segment_sum`` as ``cuda_wavefront`` calls it)."""

SOURCE = "device_trace"
UNIT = "ms"
RANGES = {"env_miss": "go_raytracing_tpu_torch.ops.cuda_wavefront:_env_miss_terms",
          "texel_sums": "go_raytracing_tpu_torch.ops.cuda_wavefront:cols_segment_sum"}


def read(run):
    s = run.trace.device_s(in_range="env_miss") + run.trace.device_s(in_range="texel_sums")
    return s * 1e3 / len(run.spans) if s > 0 else None
