"""guidance_host_ms_per_batch (program span): host time of the guide's
forward in the traced sub-window, per batch: the span ``guide.forward``
(the guidance fn called on the batch's keyframes at once), on the host's
clock: what launching the forward costs the host."""

from benchmark.harness import spans


def read(run):
    return spans.per_batch(("guide.forward",), "host_ms")
