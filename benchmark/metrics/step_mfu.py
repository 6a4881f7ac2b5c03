"""step_mfu (host clock): the whole step's arithmetic at the published
peaks over the measured time a batch (the window over the batches that
completed in it): the matcher's operations (B1-B4, as their bounds count
them) at 67 TOP/s, and with a guide its keyframes' operations as its kind
counts them (``benchmark/guides/<kind>.py work``), each unit at its peak:
CREStereo-lite's convs at 989 TFLOP/s bf16 and correlation at 67 TFLOP/s."""

from benchmark.harness import work


def read(run):
    if not run.batches:
        return None
    least = work.step_least_ms(run.batch, run.height, run.eye_width,
                               run.config["sgbm"]["num_disparities"],
                               run.keyframes, run.guide_work)
    return 100.0 * least / (run.seconds * 1e3 / run.batches)
