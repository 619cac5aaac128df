"""Profiling and render statistics (the reference's rt/profiler.go).

The reference wires Go pprof CPU / heap / block profiles and atomic render
counters.  Here, as in the JAX package's module of the same name:
  - device traces through ``torch.profiler`` (CPU and CUDA activity, a
    Chrome / Perfetto trace a run), written into ``Profiler(trace_dir=...)``;
  - render counters derived from the launch geometry (rays = pixels x spp x
    segments): the integrators trace a fixed number of segments a camera
    ray, so the counters are exact without atomics;
  - named timers with total / count / min / max / avg: CUDA events on the
    GPU (the time the device spent between the two marks), the host clock
    on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import resource
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from .device import resolve_device


@dataclasses.dataclass
class TimerStats:
    total: float = 0.0
    count: int = 0
    min: float = float("inf")
    max: float = 0.0

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    def add(self, dt: float):
        self.total += dt
        self.count += 1
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)


@dataclasses.dataclass
class RenderCounters:
    """The reference's GlobalRenderStats (rt/profiler.go:60-81)."""

    ray_count: int = 0          # camera rays + path segments
    shadow_rays: int = 0
    samples_computed: int = 0
    pixels_rendered: int = 0

    def add_launch(self, n_pixels: int, spp: int, max_depth: int, n_shadow_per_bounce: int):
        camera_rays = n_pixels * spp
        # The reference double counts primaries (RayColor + internal,
        # rt/camera.go:439,448) and counts one ray per recursion level;
        # the integrators trace exactly max_depth segments per camera ray.
        self.ray_count += camera_rays * (1 + max_depth)
        self.shadow_rays += camera_rays * max_depth * n_shadow_per_bounce
        self.samples_computed += camera_rays
        self.pixels_rendered += n_pixels


class Profiler:
    """Named timers and optional ``torch.profiler`` tracing into
    ``trace_dir``.  ``device=None`` means "cuda" (a machine without one
    raises): the timers and the trace then cover the GPU."""

    def __init__(self, trace_dir: Optional[str] = None, device=None):
        self.timers: Dict[str, TimerStats] = defaultdict(TimerStats)
        self.counters = RenderCounters()
        self.trace_dir = trace_dir
        self.device = resolve_device(device)
        self._prof = None

    def start(self):
        if self.trace_dir:
            os.makedirs(self.trace_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(self.trace_dir))
            self._prof.start()

    def stop(self):
        """End the trace; its file lands in ``trace_dir``."""
        if self._prof is not None:
            self._prof.stop()
            self._prof = None

    @contextlib.contextmanager
    def time(self, name: str):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                end.synchronize()
                self.timers[name].add(start.elapsed_time(end) * 1e-3)
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[name].add(time.perf_counter() - t0)

    def report(self, wall_seconds: float) -> str:
        """Rays/s and samples/s report (rt/profiler.go:286-313)."""
        c = self.counters
        lines = [
            "========================================",
            "         RENDER STATS REPORT",
            "========================================",
            f"Path segments:     {c.ray_count:,}",
            f"Shadow rays:       {c.shadow_rays:,}",
            f"Samples computed:  {c.samples_computed:,}",
            f"Pixels rendered:   {c.pixels_rendered:,}",
        ]
        if wall_seconds > 0:
            lines += [
                f"Segments/second:   {c.ray_count / wall_seconds:,.0f}",
                f"Mrays/s (camera):  {c.samples_computed / wall_seconds / 1e6:.3f}",
            ]
        for name, s in sorted(self.timers.items()):
            lines.append(
                f"timer {name}: total={s.total:.3f}s n={s.count} "
                f"min={s.min:.3f}s max={s.max:.3f}s avg={s.avg:.3f}s"
            )
        lines.append("========================================")
        return "\n".join(lines)


def memory_report(device=None) -> str:
    """Device and host memory report (PrintMemStats, rt/profiler.go:327-346):
    the CUDA caching allocator's live tensors, in use, peak and the card's
    size where ``device`` is a GPU (``None`` means "cuda"), and the host's
    peak resident set."""
    dev = resolve_device(device)
    lines = ["========================================", "         MEMORY REPORT"]
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        stats = torch.cuda.memory_stats(dev)
        lines.append(f"Live device arrays: {stats.get('active.all.current', 0)} "
                     f"({stats.get('active_bytes.all.current', 0) / 1e6:.1f} MB)")
        lines.append(
            f"{dev}: in_use={stats.get('allocated_bytes.all.current', 0) / 1e6:.1f}MB "
            f"peak={stats.get('allocated_bytes.all.peak', 0) / 1e6:.1f}MB "
            f"limit={torch.cuda.get_device_properties(dev).total_memory / 1e6:.0f}MB")
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    lines.append(f"Host peak RSS: {rss / 1024:.1f} MB")
    lines.append("========================================")
    return "\n".join(lines)
