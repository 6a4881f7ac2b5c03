"""The traced sub-window's arithmetic on hand-made profiler events: busy time
as the union of device operations (span ranges on the device left out),
copies, idle gaps labelled by the innermost harness span, and launches
without a device record."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness.trace import reduce

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, dev, name, start_us, end_us, corr=0):
        self._d, self._n, self._c = dev, name, corr
        self._s, self._e = start_us * 1000, end_us * 1000

    def device_type(self):
        return self._d

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def correlation_id(self):
        return self._c


def test_reduce_by_hand():
    events = [
        # host: spans, launches (one has no device record)
        Ev(CPU, "bench.upload", 0, 10),
        Ev(CPU, "bench.pipeline", 10, 100),
        Ev(CPU, "bench.guidance", 40, 90),
        Ev(CPU, "cudaMemcpyAsync", 1, 2, corr=1),
        Ev(CPU, "cudaLaunchKernel", 11, 12, corr=2),
        Ev(CPU, "cudaLaunchKernel", 41, 42, corr=3),
        Ev(CPU, "cudaLaunchKernel", 43, 44, corr=4),
        # device: a copy, two kernels overlapping, one later; span ranges
        Ev(CUDA, "Memcpy HtoD (Pinned -> Device)", 5, 15, corr=1),
        Ev(CUDA, "kern_a", 20, 50, corr=2),
        Ev(CUDA, "kern_b", 45, 60, corr=3),
        Ev(CUDA, "kern_a", 80, 100, corr=5),
        Ev(CUDA, "bench.pipeline", 5, 100),
        Ev(CUDA, "ProfilerStep#3", 0, 100),
    ]
    r = reduce(events)
    # union [5, 15] + [20, 60] + [80, 100] = 70 us of a 95 us window
    assert r["busy_s"] == pytest.approx(70e-6)
    assert r["window_s"] == pytest.approx(95e-6)
    assert r["h2d_s"] == pytest.approx(10e-6) and r["d2h_s"] == 0.0
    assert r["device_ops"][0] == ["kern_a", pytest.approx(50e-6)]
    assert len(r["device_ops"]) == 3
    # gap [15, 20] mid 17.5 lies in the pipeline span; [60, 80] mid 70
    # in the guidance span inside it
    assert dict((n, s) for n, s in r["idle_gaps"]) == {
        "bench.guidance": pytest.approx(20e-6),
        "bench.pipeline": pytest.approx(5e-6)}
    assert r["device_records"] == 4 and r["launches"] == 4
    assert r["launches_unrecorded"] == 1


def test_reduce_without_device_events():
    r = reduce([Ev(CPU, "bench.upload", 0, 10)])
    assert r == {"busy_s": 0.0, "window_s": 0.0}
