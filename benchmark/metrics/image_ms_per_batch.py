"""image_ms_per_batch (program span): device time of the stage's image ops
in the traced sub-window, per batch: the spans ``stage.eyes`` (the SBS
split and the Lanczos unsqueeze's GEMMs) and ``stage.gray`` (BT.601)."""

from benchmark.harness import spans


def read(run):
    return spans.per_batch(("stage.eyes", "stage.gray"), "device_ms")
