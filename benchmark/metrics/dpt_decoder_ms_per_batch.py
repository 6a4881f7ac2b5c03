"""dpt_decoder_ms_per_batch (program span): device time of DPT after its
ViT in the traced sub-window, per batch: the spans ``guide.neck`` (readout,
reassemble, the neck's convolutions) and ``guide.decoder`` (the fusion
stages and the head)."""

from benchmark.harness import spans


def read(run):
    return spans.per_batch(("guide.neck", "guide.decoder"), "device_ms")
