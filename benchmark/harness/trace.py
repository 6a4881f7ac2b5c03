"""The traced sub-window: ``torch.profiler`` over a fixed number of batches,
reduced to the device's busy time, its copies, its operations by time, and
its idle gaps labelled by what the harness was doing on the host.

Busy time is the length of the union of the device's kernel, copy and set
intervals (:func:`union_length`); the window is the span from the first
device operation's start to the last one's end. An idle gap is a stretch of
that window with no device operation; it is labelled by the innermost
harness span (``record_function``) open on the host at its midpoint.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

LAUNCH_WORDS = ("LaunchKernel", "LaunchCooperativeKernel", "Memcpy",
                "Memset")
# the harness's spans, and the profiler's own, which the trace also shows
# as ranges on the device
SPAN_NAMES = ("bench.", "ProfilerStep")


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def gaps(intervals) -> list:
    """(start, end) of the stretches between the union's pieces."""
    out, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def _device_op(e) -> bool:
    """A kernel, copy or set on the device; not a span's device range."""
    return (e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.name().startswith(SPAN_NAMES))


def reduce(events, top: int = 10) -> dict:
    """A summary of kineto events: busy and window seconds, copy seconds,
    device operations and idle gaps by seconds (``top`` each), and the
    launches whose device record is missing."""
    dev, spans, launches = [], [], []
    for e in events:
        if _device_op(e):
            start = e.start_ns()
            dev.append((start, start + e.duration_ns(), e.name(),
                        e.correlation_id()))
        elif (e.device_type() != torch.autograd.DeviceType.CUDA
              and e.name().startswith("bench.")):
            start = e.start_ns()
            spans.append((start, start + e.duration_ns(), e.name()))
        elif any(w in e.name() for w in LAUNCH_WORDS):
            launches.append(e.correlation_id())
    if not dev:
        return dict(busy_s=0.0, window_s=0.0)
    intervals = [(a, b) for a, b, _, _ in dev]
    t0 = min(a for a, _ in intervals)
    t1 = max(b for _, b in intervals)
    by_name = defaultdict(float)
    copy = defaultdict(float)
    for a, b, name, _ in dev:
        by_name[name] += (b - a) / 1e9
        for kind in ("HtoD", "DtoH"):
            if kind in name:
                copy[kind] += (b - a) / 1e9
    idle = defaultdict(float)
    for a, b in gaps(intervals):
        mid = (a + b) / 2
        inner = [s for s in spans if s[0] <= mid <= s[1]]
        label = (min(inner, key=lambda s: s[1] - s[0])[2] if inner
                 else "outside the harness's spans")
        idle[label] += (b - a) / 1e9
    seen = {c for _, _, _, c in dev}
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        busy_s=union_length(intervals) / 1e9, window_s=(t1 - t0) / 1e9,
        h2d_s=copy["HtoD"], d2h_s=copy["DtoH"],
        device_ops=[[n, s] for n, s in ops],
        idle_gaps=[[n, s] for n, s in
                   sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
        device_records=len(dev), launches=len(launches),
        launches_unrecorded=sum(1 for c in launches if c not in seen))


def profile_batches(driver, n: int, warmup: int = 2) -> dict:
    """Drive ``n`` batches (after ``warmup`` under the profiler's warm-up)
    under ``torch.profiler`` with the harness's spans, then synchronize;
    returns :func:`reduce` of the trace and the batches it covered."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    driver.span = record_function
    result = {}

    def ready(prof):
        result.update(reduce(prof.profiler.kineto_results.events()))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=n,
                                   repeat=1),
                 on_trace_ready=ready) as prof:
        for i in range(warmup + n):
            driver.step()
            if i == warmup + n - 1:
                driver.flush()
                torch.cuda.synchronize()
            prof.step()
    driver.span = lambda name: contextlib.nullcontext()
    result["batches"] = n
    return result
