"""crestereo_refine_ms_per_batch (program span): device time of the
published CREStereo's recurrent refinement in the traced sub-window, per
batch: the spans ``guide.refine`` (each pass's cascade of update steps,
its AGCL calls included, on the batch's keyframes at once)."""

from benchmark.harness import spans


def read(run):
    return spans.per_batch(("guide.refine",), "device_ms")
