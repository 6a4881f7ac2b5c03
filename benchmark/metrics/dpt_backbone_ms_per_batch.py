"""dpt_backbone_ms_per_batch (program span): device time of DPT's ViT in the
traced sub-window, per batch: the span ``guide.backbone`` (the patch
embedding, the position embeddings and the blocks, on the batch's
keyframes at once)."""

from benchmark.harness import spans


def read(run):
    return spans.per_batch(("guide.backbone",), "device_ms")
