"""dpt_backbone_roofline_pct (program span): DPT's ViT's least time over
``dpt_backbone_ms_per_batch``. The least time is the run's keyframes a
batch times one keyframe's bfloat16 operations (the patch embedding, the
blocks' linears, q k^T and p v, as the guide's kind counts them:
``benchmark/guides/<kind>.py backbone_flops``) at 989 TFLOP/s."""

from pathlib import Path

from benchmark.harness import spans, work
from benchmark.harness.registry import Registry

BENCH = Path(__file__).resolve().parents[1]


def read(run):
    ms = spans.per_batch(("guide.backbone",), "device_ms")
    if not ms:
        return None
    guide = run.config["guide"]
    kind = Registry(BENCH.parent, BENCH).guide(guide["kind"])
    least = (run.keyframes * kind.backbone_flops(guide)
             / work.PEAK_OPS_S["bf16"] * 1e3)
    return 100.0 * least / ms
