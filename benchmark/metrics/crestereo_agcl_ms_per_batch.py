"""crestereo_agcl_ms_per_batch (program span): device time of the published
CREStereo's adaptive group correlation in the traced sub-window, per
batch: the spans ``guide.agcl`` (each AGCL call, inside ``guide.refine``:
the deformable ones at 1/16 and 1/8 and the warped ones at 1/4)."""

from benchmark.harness import spans


def read(run):
    return spans.per_batch(("guide.agcl",), "device_ms")
