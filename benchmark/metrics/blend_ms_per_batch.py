"""blend_ms_per_batch (program span): device time of the hole fill and the
guidance blend in the traced sub-window, per batch: the spans
``stage.fill`` and ``stage.blend`` (everything after the guide's output:
the keyframes' expansion and the confidence-trust blend)."""

from benchmark.harness import spans


def read(run):
    return spans.per_batch(("stage.fill", "stage.blend"), "device_ms")
