"""image_ms_per_batch (program span): device time of the stage's image ops
in the traced sub-window, per batch: the span ``stage.eyes``, which holds
kernel I1 (the SBS split, the 2x Lanczos-4 unsqueeze and BT.601 in one
launch). ``stage.gray`` is summed too where a program still records it."""

from benchmark.harness import spans


def read(run):
    return spans.per_batch(("stage.eyes", "stage.gray"), "device_ms")
