"""Tracing from the benchmark's own files: ``record_function`` ranges put
around the program's layer entry functions, and the reading of the
``torch.profiler`` trace of the window.

A range is named by a per-layer metric (its ``RANGES``: range name ->
``module:function``); ``install`` wraps each function on its module, so the
program's own calls by that name go through the range.  In a traced run the
wrapper also records a CUDA event before and after each call, so the
device time read from the trace can be held against the events' times.

``Trace`` reads the trace once: each device operation (kernel, copy, set)
with its start, length and the range that launched it (the range on the
host thread whose span holds the operation's launch), each range's device
span (from a call's first operation to its last, summed over the calls:
what the CUDA events measure), the busy time (the union of the
operations' spans), and the idle gaps, each labelled by the innermost host
operation running when the device fell idle.
"""

from __future__ import annotations

import bisect
import importlib
import re
from collections import defaultdict

import torch

PREFIX = "portbench::"
WINDOW = "portbench_window"   # the range around the whole window


class CallEvents:
    """CUDA events around each call of a range, summed after the window."""

    def __init__(self):
        self.pairs = defaultdict(list)

    def seconds(self):
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v) * 1e-3 for k, v in self.pairs.items()}


def install(ranges: dict, events: CallEvents | None = None):
    """Wrap each ``module:function`` of ``ranges`` in its range.  Returns
    a function that puts the originals back."""
    undo = []
    for name, target in ranges.items():
        mod_name, fn_name = target.split(":")
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, fn_name)

        def wrapped(*a, __orig=orig, __name=PREFIX + name, **kw):
            with torch.profiler.record_function(__name):
                if events is None:
                    return __orig(*a, **kw)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = __orig(*a, **kw)
                end.record()
                events.pairs[__name[len(PREFIX):]].append((start, end))
                return out

        setattr(mod, fn_name, wrapped)
        undo.append((mod, fn_name, orig))

    def restore():
        for mod, fn_name, orig in undo:
            setattr(mod, fn_name, orig)
    return restore


def _on_host(e):
    return e.device_type() == torch.autograd.DeviceType.CPU


def _is_device(e):
    """A kernel, copy or set on the device (not the device-side copy of a
    host range, which kineto also puts there)."""
    return (not _on_host(e)
            and not getattr(e, "is_user_annotation", lambda: False)()
            and not e.name().startswith((PREFIX, WINDOW)))


class Trace:
    """What a window's trace says (times in seconds)."""

    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        host = [e for e in events if _on_host(e)]
        dev = [e for e in events if _is_device(e) and e.duration_ns() > 0]
        window = [e for e in host if e.name() == WINDOW]
        window_start_ns, window_end_ns = window[0].start_ns(), window[0].end_ns()
        # a device operation's launch is the runtime call with its CUPTI
        # correlation id, else the torch op it is linked to: the two kinds of
        # id are counted apart and overlap, so they are kept apart
        runtime, torch_ops = {}, {}
        for e in host:
            kind = runtime if e.name().startswith("cu") else torch_ops
            kind.setdefault(e.correlation_id(), e)
        # ranges on the host, by start
        rng = sorted((e.start_ns(), e.end_ns(), e.name()[len(PREFIX):]) for e in host
                     if e.name().startswith(PREFIX))
        starts = [r[0] for r in rng]

        def range_of(t):
            # the ranges do not nest: the last one to start before t, if it
            # has not ended
            i = bisect.bisect_right(starts, t) - 1
            return i if i >= 0 and t <= rng[i][1] else None

        self.ops = []   # (name, start_ns, dur_ns, range or None)
        unlinked = by_op = 0
        reach = {}      # range instance -> [first op's start, last op's end]
        for e in dev:
            launch = runtime.get(e.correlation_id() or -1)
            if launch is None:
                launch = torch_ops.get(e.linked_correlation_id() or -1)
                by_op += launch is not None
            if launch is None:
                unlinked += 1
            t = launch.start_ns() if launch is not None else e.start_ns()
            i = range_of(t)
            self.ops.append((e.name(), e.start_ns(), e.duration_ns(),
                             rng[i][2] if i is not None else None))
            if i is not None:
                a, b = e.start_ns(), e.start_ns() + e.duration_ns()
                r = reach.setdefault(i, [a, b])
                r[0], r[1] = min(r[0], a), max(r[1], b)
        self.ops.sort(key=lambda o: o[1])
        self.unlinked, self.by_op = unlinked, by_op
        # a range's device span: each call's first operation to its last,
        # idle gaps included, summed over its calls (what CUDA events around
        # the calls measure)
        self.span_s = defaultdict(float)
        for i, (a, b) in reach.items():
            self.span_s[rng[i][2]] += (b - a) * 1e-9
        self.window_s = (window_end_ns - window_start_ns) * 1e-9
        # busy: the union of the operations' spans, clipped to the window
        busy, gaps = 0, []
        cur_s = cur_e = None
        for _, s, d, _ in self.ops:
            s, e = max(s, window_start_ns), min(s + d, window_end_ns)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        self.busy_s = busy * 1e-9
        # each idle gap labelled by the innermost host operation at its start
        spans = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in host),
                       key=lambda x: (x[0], -x[1]))
        idle = defaultdict(int)
        j, stack = 0, []
        for a, b in gaps:
            while j < len(spans) and spans[j][0] <= a:
                stack.append(spans[j])
                j += 1
            stack = [s for s in stack if s[1] >= a]
            label = min(stack, key=lambda s: s[1] - s[0])[2] if stack else "(no host op)"
            idle[label] += b - a
        self.idle = sorted(((k, v * 1e-9) for k, v in idle.items()), key=lambda kv: -kv[1])

    def kernels(self, pattern=None):
        """Device kernels (not copies or sets), optionally those whose name
        matches the regular expression ``pattern``."""
        rx = re.compile(pattern) if pattern else None
        return [o for o in self.ops if not o[0].startswith(("Memcpy", "Memset"))
                and (rx is None or rx.search(o[0]))]

    def device_s(self, pattern=None, in_range=None):
        """Device seconds of the kernels matching ``pattern`` (all device
        operations when None), or of every operation launched inside the
        range ``in_range``."""
        ops = self.kernels(pattern) if pattern else self.ops
        if in_range is not None:
            ops = [o for o in ops if o[3] == in_range]
        return sum(o[2] for o in ops) * 1e-9

    def breakdown(self):
        by_name = defaultdict(int)
        for name, _, d, _ in self.ops:
            by_name[name] += d
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v * 1e-9] for k, v in top],
                "idle_gaps": [[k, v] for k, v in self.idle[:10]]}
