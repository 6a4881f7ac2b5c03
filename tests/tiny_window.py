"""Tiny benchmark cells and guide networks run on the CPU beside other
test workers.

A run compares batches that completed inside its window, and a window
with none raises. A fixed window held a batch on an idle machine and not
always beside five other workers, so a test measures the cell's own batch
time first (the program built as the cell builds it, two batches after two
of warm-up) and gives the run a window of ``BATCHES`` of them, never less
than its own floor (:func:`window_seconds`).

A guide network's forward is thousands of small operations. On all of a
machine's cores each is split across threads that wait on each other, and
beside other workers doing the same that took a tiny cell from ~12 s to
over 140 s; on one thread it takes ~12 s either way
(:func:`one_thread`).
"""

from __future__ import annotations

import time

import pytest
import torch

BATCHES = 6  # batches of the measured time a window holds


@pytest.fixture
def one_thread():
    """torch on one intra-op thread for the test, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def window_seconds(reg, workload: str, floor: float) -> float:
    """``floor`` seconds, or ``BATCHES`` of the cell's measured batch time
    if that is longer."""
    from benchmark.harness import driver as drv

    cell = reg.cell(workload)
    config, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    stage, _, opts = drv.build(reg, config, traffic, "cpu")
    clip = reg.generator(traffic["generator"])(traffic, 0, "cpu")["frames"]
    d = drv.Driver(stage.depth_batch_pipeline, opts, clip.cpu().numpy(),
                   traffic["batch"], "cpu", stage.host_copy_async)
    for _ in range(2):
        d.step()
    t = time.perf_counter()
    for _ in range(2):
        d.step()
    d.flush()
    return max(floor, BATCHES * (time.perf_counter() - t) / 2)
