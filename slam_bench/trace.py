"""The traced run's records: the matcher's launch shapes and the device
trace of a short sub-window under `torch.profiler`, read from the
profiler's raw events (the trace stays in memory; nothing is written).

`MatcherShapes` wraps the name the program's map operations call the
matcher by, for the sub-window only, and records each launch's keypoint
count, candidate count and valid candidates (kept on the device until the
sub-window ends, so the wrapper adds no synchronise)."""

from __future__ import annotations

import re

import torch

# the matcher's three CUDA kernels (csrc/gated_top2_hamming.cu), named in
# an anonymous namespace
MATCHER_KERNEL = re.compile(
    r"(anonymous namespace\)::|_GLOBAL__N_1\d+)(compact_tile|tile|merge)_kernel")


# the profiler's own bookkeeping on the host, not the program's
PROFILER_OWN = ("Activity Buffer",)


class MatcherShapes:
    """Context manager: while open, every call of the matcher through
    `module.<name>` records (K, NC, valid candidates)."""

    def __init__(self, module, name: str = "gated_top2_hamming"):
        self.module, self.name = module, name
        self._pending = []

    def __enter__(self):
        fn = self._orig = getattr(self.module, self.name)
        pending = self._pending

        def recorded(*args, **kw):
            kp_desc, pt_desc, pt_valid = args[0], args[4], args[9]
            pending.append((int(kp_desc.shape[0]), int(pt_desc.shape[0]),
                            pt_valid.sum()))
            return fn(*args, **kw)

        setattr(self.module, self.name, recorded)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._orig)
        return False

    def launches(self) -> list:
        """[(K, NC, n_valid)] of the calls made while open."""
        return [(K, NC, int(v)) for K, NC, v in self._pending]


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def read_profile(prof) -> dict:
    """From a finished `torch.profiler.profile`: the device operations
    [(name, start_s, end_s)] (kernels, copies and sets; the mirrored
    annotations left out) and the host's events [(name, start_s, end_s,
    is_annotation)], on one clock; the profiler's own bookkeeping on the
    host apart, as `own` [(name, start_s, end_s)]."""
    dev, host, own = [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append(row)
        elif row[0].startswith(PROFILER_OWN):
            own.append(row)
        else:
            host.append(row + (bool(e.is_user_annotation()),))
    return {"device_ops": dev, "host": host, "own": own}


def _idle_gaps(device_ops: list, t0: float, t1: float) -> list:
    """[(start, end)] in [t0, t1] in which no device operation ran."""
    gaps, end = [], t0
    for a, b in sorted((a, b) for _, a, b in device_ops):
        if a > end:
            gaps.append((end, min(a, t1)))
        end = max(end, b)
    if t1 > end:
        gaps.append((end, t1))
    return [(a, b) for a, b in gaps if b > a]


def idle_during(device_ops: list, own: list, t0: float, t1: float) -> float:
    """Seconds of [t0, t1] in which the device was idle while the host ran
    the profiler's own bookkeeping (`own`, [(name, start_s, end_s)]): the
    idle time that tracing adds at the most."""
    spans, total = [], 0.0
    for _, a, b in own:
        spans.append((max(a, t0), min(b, t1)))
    for ga, gb in _idle_gaps(device_ops, t0, t1):
        total += union_s((max(a, ga), min(b, gb)) for a, b in spans
                         if min(b, gb) > max(a, ga))
    return total


def breakdown(device_ops: list, host: list, t0: float, t1: float,
              top: int = 10, own: list = ()) -> dict:
    """The device operations that took most time, summed by name, and the
    longest idle gaps of the device in [t0, t1], each named by what the
    host was doing at the gap's middle: the innermost annotation (the
    program's stage spans, the harness's own) and the innermost operator
    around that instant, or `profiler/<event>` where the profiler's own
    bookkeeping (`own`) ran then."""
    by_name = {}
    for name, a, b in device_ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((b - a, a, b) for a, b in _idle_gaps(device_ops, t0, t1)),
                  reverse=True)
    named = []
    for length, a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        mine = next((name for name, h0, h1 in own if h0 <= mid <= h1), None)
        around = [(h1 - h0, name, ann) for name, h0, h1, ann in host
                  if h0 <= mid <= h1]
        outer = min((x for x in around if x[2]), default=None)
        inner = min((x for x in around if not x[2]), default=None)
        label = "/".join(x[1] for x in (outer, inner) if x is not None)
        if mine is not None:
            label = "profiler/" + mine
        named.append([label or "host outside any span", length])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
