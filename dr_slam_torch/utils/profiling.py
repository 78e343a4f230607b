"""Stage profiling: the reference's `StageProfiler` (count, total, mean,
p50 and p95 ms per named span), with each span's parent, self time and host
syncs, and `stage_span`, the block every stage of the port runs in.

`PROFILER` is off by default; `DRSLAM_PROFILE_STAGES=1` in the environment
or `PROFILER.enable()` turns it on. Every span is host time on one
monotonic clock, `time.perf_counter_ns` plus an offset fixed at `enable()`
that puts it on the clock of `torch.profiler`'s events (the Unix clock), so
a span and its `record_function` event in a trace cover the same interval.
While enabled the profiler keeps one record per span (`Span`, in
`records`, in order of entry): name, parent (the innermost span open at
entry), frame id (given to the root span, `track.call`, and inherited by
the spans inside it), start, end, and the host syncs counted in it. It
times the thread that called `enable()`, the one that tracks: a span
opened on another thread (the live viewer's worker extracts a frame's
features again for its overlay) records nothing, and a sync there is not
counted.

Host syncs: while enabled on a machine with CUDA, the profiler sets
`torch.cuda.set_sync_debug_mode("warn")`, so that every implicit wait of
the host for the device (`.item()`, `.cpu()`, `nonzero`, boolean indexing,
a blocking host-to-device copy) raises a warning; each is counted into the
innermost open span and none is shown. The explicit waits are counted at
their sites with `count_sync()`. `disable()` restores the sync mode and
the warning filters. Off, a span costs one check: it records nothing,
allocates nothing on the device and never synchronises, and the sync mode
is never touched.

Stream time: `device_span(name, device)` records a timing CUDA event on
the current stream before and after the host enqueues a block's work (the
detector's network on its own stream). The time between them is the
stream's wall time, not the block's kernel time: it includes gaps where
the stream waits for the host to launch the next kernel, and time the
kernels share the card with other streams'. The elapsed time is read only
once the end event is done, never waited for, and `summary()` gives each
such name its `count` of timed blocks, `device_ms` total (that stream
time), the `pending` blocks not yet done and `syncs` 0. On the CPU, or
off, it records nothing.

`stage_span(name, frame)` is a `torch.profiler.record_function` block
under the reference's span name (`track.dispatch`, `kf.local_ba`,
`loop.process`, ...) and a `PROFILER` span, so a device trace carries
every span on its own clock.

Usage:
    from dr_slam_torch.utils.profiling import PROFILER, stage_span
    with stage_span("kf.local_ba"):
        ...
    PROFILER.summary()  # {stage: {count, total_ms, mean_ms, p50_ms, p95_ms,
                        #          self_ms, syncs, parent, parents},
                        #  device span: {count, device_ms, pending, syncs}}
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
import warnings

import torch

# the warning that torch.cuda's sync debug mode raises at each sync
SYNC_WARNING = "called a synchronizing CUDA operation"


def _unix_offset_ns(reads: int = 8) -> int:
    """The Unix clock less `time.perf_counter_ns`, from the read of
    `time.time_ns` most tightly bracketed by two of the monotonic clock (a
    thread preempted between two reads would shift every span)."""
    best = None
    for _ in range(reads):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, unix - (a + b) // 2)
    return best[1]


class Span:
    """One span's record; `parent` is the index of the enclosing span's
    record in `StageProfiler.records` (-1: none), `end_ns` None while
    open."""
    __slots__ = ("name", "parent", "frame", "start_ns", "end_ns", "syncs")

    def __init__(self, name: str, parent: int, frame, start_ns: int):
        self.name, self.parent, self.frame = name, parent, frame
        self.start_ns, self.end_ns, self.syncs = start_ns, None, 0

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class StageProfiler:
    def __init__(self):
        self.records: list[Span] = []
        self._device: list = []      # (name, start, end) timing events
        self._device_ms = collections.defaultdict(list)
        self._open: list[int] = []   # open spans' indices, innermost last
        self._offset_ns = 0
        self._watch = None           # (sync mode, catch_warnings): counting
        self._owner = None           # the thread that is timed
        self.enabled = False
        if os.environ.get("DRSLAM_PROFILE_STAGES"):
            self.enable()

    def enable(self):
        if self.enabled:
            return
        self._offset_ns = _unix_offset_ns()
        self._owner = threading.get_ident()
        self.enabled = True
        if torch.cuda.is_available():
            self._watch_syncs()

    def disable(self):
        if not self.enabled:
            return
        self.enabled = False
        if self._watch is not None:
            mode, catcher = self._watch
            self._watch = None
            torch.cuda.set_sync_debug_mode(mode)
            catcher.__exit__(None, None, None)

    def reset(self):
        self.records.clear()
        self._open.clear()
        self._device.clear()
        self._device_ms.clear()

    def _watch_syncs(self):
        """Count torch.cuda's sync warnings instead of showing them, each
        time ("always": the default filter shows a location once)."""
        catcher = warnings.catch_warnings()
        catcher.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.filterwarnings(
            "ignore", message="Synchronization debug mode is a prototype")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                self.count_sync()
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        self._watch = (torch.cuda.get_sync_debug_mode(), catcher)
        torch.cuda.set_sync_debug_mode("warn")

    def count_sync(self):
        """One wait of the host for the device, counted into the innermost
        open span (outside every span, or on another thread, it is not
        counted)."""
        if (self.enabled and self._open
                and threading.get_ident() == self._owner):
            self.records[self._open[-1]].syncs += 1

    def _now_ns(self) -> int:
        return time.perf_counter_ns() + self._offset_ns

    @contextlib.contextmanager
    def span(self, name: str, frame=None):
        """Time a stage on the host. `frame` is the frame id; None takes
        the enclosing span's."""
        if not self.enabled or threading.get_ident() != self._owner:
            yield
            return
        parent = self._open[-1] if self._open else -1
        if frame is None and parent >= 0:
            frame = self.records[parent].frame
        rec = Span(name, parent, frame, self._now_ns())
        self._open.append(len(self.records))
        self.records.append(rec)
        try:
            yield
        finally:
            rec.end_ns = self._now_ns()
            if self._open and self.records[self._open[-1]] is rec:
                self._open.pop()

    @contextlib.contextmanager
    def device_span(self, name: str, device):
        """The current CUDA stream's time from before to after the block
        enqueues its work, launch gaps and time shared with other streams
        included: read by `summary()` once done, never waited for."""
        if (not self.enabled or device.type != "cuda"
                or threading.get_ident() != self._owner):
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self._device.append((name, start, end))

    def _read_device(self) -> dict:
        """The device spans done so far into `_device_ms`; the count of
        those not yet done, per name."""
        pending = collections.Counter()
        left = []
        for name, start, end in self._device:
            if end.query():
                self._device_ms[name].append(start.elapsed_time(end))
            else:
                pending[name] += 1
                left.append((name, start, end))
        self._device = left
        return pending

    def summary(self) -> dict:
        """Per span name over the closed spans: count, total_ms, mean_ms,
        p50_ms, p95_ms; self_ms, the total less the time its child spans
        cover; syncs, those counted in the span itself (not in its
        children); parent, the enclosing span's name that most of its
        records had (None at the root); parents, the count of its records
        under each enclosing span's name (the root ones left out). Each
        device span's name: count of the timed blocks done, device_ms (the
        stream's time between its events), pending (not done yet), syncs
        0."""
        recs = self.records
        child_ns = [0] * len(recs)
        by_name = collections.defaultdict(list)
        for i, r in enumerate(recs):
            if r.end_ns is None:
                continue
            by_name[r.name].append(i)
            if r.parent >= 0:
                child_ns[r.parent] += r.end_ns - r.start_ns
        out = {}
        for name, idx in sorted(by_name.items()):
            s = sorted(recs[i].ms for i in idx)
            n = len(s)
            own_ns = sum(recs[i].end_ns - recs[i].start_ns - child_ns[i]
                         for i in idx)
            parents = collections.Counter(
                recs[recs[i].parent].name if recs[i].parent >= 0 else None
                for i in idx)
            out[name] = {
                "count": n,
                "total_ms": round(sum(s), 3),
                "mean_ms": round(sum(s) / n, 3),
                "p50_ms": round(s[n // 2], 3),
                "p95_ms": round(s[min(n - 1, int(0.95 * n))], 3),
                "self_ms": round(own_ns * 1e-6, 3),
                "syncs": sum(recs[i].syncs for i in idx),
                "parent": parents.most_common(1)[0][0],
                "parents": {p: c for p, c in parents.items() if p is not None},
            }
        pending = self._read_device()
        for name in sorted(set(self._device_ms) | set(pending)):
            ms = self._device_ms.get(name, [])
            out[name] = {"count": len(ms), "device_ms": round(sum(ms), 3),
                         "pending": pending[name], "syncs": 0}
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)


PROFILER = StageProfiler()


@contextlib.contextmanager
def stage_span(name: str, frame=None):
    """A `record_function` block and a `PROFILER` span, both `name`."""
    with torch.profiler.record_function(name), PROFILER.span(name, frame):
        yield
