"""Stage spans: a `torch.profiler.record_function` block under the
reference's span name (`kf.local_ba`, `loop.process`, ...), and, when the
caller collects them, a pair of CUDA events around the stage.

`events` is None or a list; on the GPU each span appends (name, start, end)
to it, for the caller to read with `start.elapsed_time(end)` once it has
synchronised. That is the stream time between the two events: for a stage
bound by the host's launches it is the stage's wall time."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def stage_span(name: str, events: list | None, device: torch.device):
    with torch.profiler.record_function(name):
        if events is None or device.type != "cuda":
            yield
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        events.append((name, a, b))
