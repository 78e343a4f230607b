"""Stage profiling: the reference's `StageProfiler` (count, total, mean,
p50 and p95 ms per named span), and `stage_span`, the block every stage of
the port runs in.

`PROFILER` is off by default; `DRSLAM_PROFILE_STAGES=1` in the environment
or `PROFILER.enable()` turns it on. A span on the GPU records a pair of CUDA
events on the current stream and adds no synchronise of its own: the
elapsed times are read in `summary()`, after one synchronise. That is the
stream time between the two events; for a stage bound by the host's
launches it is the stage's wall time. A span on the CPU, or one given no
device, is timed with `time.perf_counter`.

`stage_span(name, events, device)` is a `torch.profiler.record_function`
block under the reference's span name (`kf.local_ba`, `loop.process`, ...)
and a `PROFILER` span. `events` is None or a list: on the GPU each span
also appends (name, start, end) CUDA events to it, for the caller to read
with `start.elapsed_time(end)` once it has synchronised.

Usage:
    from dr_slam_torch.utils.profiling import PROFILER
    with PROFILER.span("track.device", device=dev):
        ...
    PROFILER.summary()  # {stage: {count, total_ms, mean_ms, p50_ms, p95_ms}}
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time

import torch


def _on_cuda(device, sync) -> bool:
    if device is not None:
        return torch.device(device).type == "cuda"
    return isinstance(sync, torch.Tensor) and sync.is_cuda


class StageProfiler:
    def __init__(self):
        self._times = collections.defaultdict(list)  # name -> [ms]
        self._events = []        # (name, start, end) CUDA events not yet read
        self.enabled = bool(os.environ.get("DRSLAM_PROFILE_STAGES"))

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def reset(self):
        self._times.clear()
        self._events.clear()

    @contextlib.contextmanager
    def span(self, name: str, sync=None, device=None):
        """Time a stage. With `device` a CUDA device, or `sync` a CUDA
        tensor, the span is a pair of CUDA events around the stage's work
        on the current stream; else host time."""
        if not self.enabled:
            yield
            return
        if _on_cuda(device, sync):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            try:
                yield
            finally:
                b.record()
                self._events.append((name, a, b))
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name].append((time.perf_counter() - t0) * 1e3)

    def record(self, name: str, ms: float):
        if self.enabled:
            self._times[name].append(ms)

    def _read_events(self):
        if not self._events:
            return
        torch.cuda.synchronize()
        for name, a, b in self._events:
            self._times[name].append(a.elapsed_time(b))
        self._events.clear()

    def summary(self) -> dict:
        self._read_events()
        out = {}
        for name, ts in sorted(self._times.items()):
            s = sorted(ts)
            n = len(s)
            out[name] = {
                "count": n,
                "total_ms": round(sum(s), 3),
                "mean_ms": round(sum(s) / n, 3),
                "p50_ms": round(s[n // 2], 3),
                "p95_ms": round(s[min(n - 1, int(0.95 * n))], 3),
            }
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)


PROFILER = StageProfiler()


@contextlib.contextmanager
def stage_span(name: str, events: list | None = None, device=None):
    with torch.profiler.record_function(name), \
            PROFILER.span(name, device=device):
        if events is None or not _on_cuda(device, None):
            yield
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        events.append((name, a, b))
