"""crestereo_refine_roofline_pct (program span): the published CREStereo's
refinement's least time over ``crestereo_refine_ms_per_batch``. The least
time is the run's keyframes a batch times one forward's update steps'
bfloat16 operations at 989 TFLOP/s plus its AGCL calls' float32 feature
maps read once and correlations written once at 3.35 TB/s, as the guide's
kind counts them (``benchmark/guides/<kind>.py refine_least_ms``)."""

from pathlib import Path

from benchmark.harness import spans
from benchmark.harness.registry import Registry

BENCH = Path(__file__).resolve().parents[1]


def read(run):
    ms = spans.per_batch(("guide.refine",), "device_ms")
    if not ms:
        return None
    guide = run.config["guide"]
    kind = Registry(BENCH.parent, BENCH).guide(guide["kind"])
    return 100.0 * kind.refine_least_ms(guide, run.height, run.eye_width,
                                        run.keyframes) / ms
