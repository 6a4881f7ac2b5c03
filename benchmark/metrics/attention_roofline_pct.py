"""attention_roofline_pct (program span): kernel B7's least time over the
device time of the span ``guide.attention`` (each B7 call), per batch.
B7's least time is, per call, the larger of its bfloat16 q, k, v and
output moved once at 3.35 TB/s and its q k^T and p v at 989 TFLOP/s, one
call a block on the batch's keyframes (the guide's kind counts it:
``benchmark/guides/<kind>.py attention_least_ms``)."""

from pathlib import Path

from benchmark.harness import spans
from benchmark.harness.registry import Registry

BENCH = Path(__file__).resolve().parents[1]


def read(run):
    ms = spans.per_batch(("guide.attention",), "device_ms")
    if not ms:
        return None
    guide = run.config["guide"]
    kind = Registry(BENCH.parent, BENCH).guide(guide["kind"])
    return 100.0 * kind.attention_least_ms(guide, run.keyframes) / ms
