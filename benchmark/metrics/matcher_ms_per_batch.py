"""matcher_ms_per_batch (program span): CUDA events around each call of
ops/stereo.py sgbm_disparity from the depth stage, through the window; the
mean a call (one call a batch)."""


def read(run):
    if not run.matcher_ms:
        return None
    return sum(run.matcher_ms) / len(run.matcher_ms)
