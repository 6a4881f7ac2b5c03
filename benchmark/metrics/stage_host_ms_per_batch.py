"""stage_host_ms_per_batch (program span): host time of the depth stage's
call in the traced sub-window, per batch: the span ``stage``
(``depth_batch_pipeline`` from entry to return: its launches, and any
wait on the device inside it)."""

from benchmark.harness import spans


def read(run):
    return spans.per_batch(("stage",), "host_ms")
