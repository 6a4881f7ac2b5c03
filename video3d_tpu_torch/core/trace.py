"""Spans at the port's layer boundaries, recorded only under torch.profiler.

A span (:func:`span`) marks one call of a layer: its name, host start and
end, the span it opened inside, the batch of the enclosing ``stage`` span,
its counts, and, where the site names a CUDA tensor or device (``on``), a
pair of timing events on that device's current stream. Host times are
Unix-epoch nanoseconds (``time.time_ns()``), the clock of the profiler's
host events (kineto's ``start_ns()``), so a span lines up with the
kernels' launches in a device trace.

Spans record only while a ``torch.profiler`` profile records (its active
steps): the benchmark's traced sub-window and the CLI's ``--profile-dir``.
Otherwise :func:`span` reads one flag and returns a shared no-op context.
Spans are neither ``record_function`` nor NVTX ranges, so they add nothing
to the profiler's own events or to the device's busy time; they reach a
trace file only through :func:`merge_chrome_trace`. Under the profiler an
event record costs the host about 20 us (an H100 with torch 2.11), so the
sites that time the device are the stage's steps and the matcher's, and
the guide's inner spans are host-only. Nothing here waits for the device:
device times are read at :func:`summary` (synchronise before it to have
them all), or, where more than ``READ_EVERY`` records wait, as a top-level
span closes, from the events that have completed. Records stay in memory
until :func:`reset`.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _profiler

BATCH_SPAN = "stage"  # each span of this name is a batch
READ_EVERY = 4096  # records whose events may wait unread
_NULL = contextlib.nullcontext()


class _Record:
    __slots__ = ("name", "parent", "batch", "counts", "device", "start_ns",
                 "end_ns", "events", "device_ms")


class Recorder:
    """The spans opened since the last :meth:`reset`, in the order they
    opened, from the one thread that runs the stage."""

    def __init__(self):
        self.records: list = []
        self._open: list = []  # indices of the open spans, innermost last
        self._batches = 0
        self._unread = 0  # every record before it has its device time

    def open(self, name: str, on, counts: dict) -> _Record:
        r = _Record()
        r.name, r.counts = name, counts
        r.parent = self._open[-1] if self._open else None
        if name == BATCH_SPAN:
            r.batch = self._batches
            self._batches += 1
        else:
            r.batch = (self.records[r.parent].batch if r.parent is not None
                       else None)
        device = getattr(on, "device", on)
        r.device = device if device is not None and device.type == "cuda" \
            else None
        r.end_ns = r.events = r.device_ms = None
        self._open.append(len(self.records))
        self.records.append(r)
        r.start_ns = time.time_ns()
        if r.device is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(r.device))
            r.events = (start, None)
        return r

    def close(self, r: _Record) -> None:
        if r.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(r.device))
            r.events = (r.events[0], end)
        r.end_ns = time.time_ns()
        self._open.pop()
        if not self._open and len(self.records) - self._unread > READ_EVERY:
            self._read_events()

    def _read_events(self) -> None:
        """Device times of the records whose end event has completed, in
        order, up to the first that has not."""
        i = self._unread
        while i < len(self.records):
            r = self.records[i]
            if r.events is not None:
                start, end = r.events
                if end is None or not end.query():
                    break
                r.device_ms = start.elapsed_time(end)
                r.events = None
            i += 1
        self._unread = i

    def summary(self) -> dict:
        """{name: {count, host_ms, device_ms, device_count, counts}}:
        the spans of each name, their host and device milliseconds
        summed (``device_count`` spans have a device time), and their
        counts summed by key."""
        self._read_events()
        out = {}
        for r in self.records:
            s = out.setdefault(r.name, dict(count=0, host_ms=0.0,
                                            device_ms=0.0, device_count=0,
                                            counts={}))
            s["count"] += 1
            if r.end_ns is not None:
                s["host_ms"] += (r.end_ns - r.start_ns) / 1e6
            if r.device_ms is not None:
                s["device_ms"] += r.device_ms
                s["device_count"] += 1
            for k, v in r.counts.items():
                s["counts"][k] = s["counts"].get(k, 0) + v
        return out

    def as_dicts(self) -> list:
        """Each record as a dict; ``parent`` is an index into the list."""
        self._read_events()
        return [dict(name=r.name, parent=r.parent, batch=r.batch,
                     start_ns=r.start_ns, end_ns=r.end_ns,
                     counts=dict(r.counts), device_ms=r.device_ms)
                for r in self.records]

    def reset(self) -> None:
        """Forget every record (call it outside any span)."""
        self.records = []
        self._open = []
        self._batches = 0
        self._unread = 0


class _Span:
    __slots__ = ("recorder", "name", "on", "counts", "record")

    def __init__(self, recorder: Recorder, name: str, on, counts: dict):
        self.recorder, self.name, self.on, self.counts = (recorder, name, on,
                                                          counts)

    def __enter__(self):
        self.record = self.recorder.open(self.name, self.on, self.counts)
        return self

    def __exit__(self, *exc) -> bool:
        self.recorder.close(self.record)
        return False


RECORDER = Recorder()


def span(name: str, on=None, **counts):
    """A context that records a span named ``name`` with ``counts`` while a
    profiler records, and does nothing otherwise. ``on``: a tensor (or
    device) whose CUDA stream the span's events time; None (or a CPU
    one): host times only."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(RECORDER, name, on, counts)


def summary() -> dict:
    """:meth:`Recorder.summary` of the process's recorder."""
    return RECORDER.summary()


def records() -> list:
    """:meth:`Recorder.as_dicts` of the process's recorder."""
    return RECORDER.as_dicts()


def reset() -> None:
    """Forget the process's records."""
    RECORDER.reset()


def format_summary(table: dict) -> str:
    """A :func:`summary` as a text table, one span name a line."""
    lines = [f"{'span':<20} {'count':>6} {'host ms':>11} {'device ms':>11}"
             f"  counts"]
    for name, s in table.items():
        dev = f"{s['device_ms']:11.3f}" if s["device_count"] else \
            f"{'-':>11}"
        counts = " ".join(f"{k}={v}" for k, v in s["counts"].items())
        lines.append(f"{name:<20} {s['count']:>6} {s['host_ms']:11.3f} "
                     f"{dev}  {counts}")
    return "\n".join(lines)


# the spans' track in a Chrome trace: a process id of its own
TRACK_PID = 0x7FFF0000


def merge_chrome_trace(path, recorder: Recorder = RECORDER) -> int:
    """Add ``recorder``'s closed spans to the Chrome trace at ``path`` (as
    ``torch.profiler``'s ``export_chrome_trace`` writes it) as a host track
    of their own, on the trace's time base: ``ts`` in microseconds from
    its ``baseTimeNanoseconds`` (0 where the file has none). Returns the
    number of spans added."""
    path = Path(path)
    doc = json.loads(path.read_text())
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = [dict(name="process_name", ph="M", pid=TRACK_PID, tid=0,
                   args=dict(name="video3d_tpu_torch spans"))]
    for rec in recorder.as_dicts():
        if rec["end_ns"] is None:
            continue
        args = dict(rec["counts"], batch=rec["batch"])
        if rec["device_ms"] is not None:
            args["device_ms"] = rec["device_ms"]
        events.append(dict(
            name=rec["name"], cat="program_span", ph="X", pid=TRACK_PID,
            tid=0, ts=(rec["start_ns"] - base) / 1e3,
            dur=(rec["end_ns"] - rec["start_ns"]) / 1e3, args=args))
    doc["traceEvents"].extend(events)
    path.write_text(json.dumps(doc))
    return len(events) - 1
