"""guidance_ms_per_batch (program span): CUDA events around each call of the
resolved guidance fn (models/crestereo.py, the keyframes of a batch at
once), through the window; the mean a call (one call a batch)."""


def read(run):
    if not run.guidance_ms:
        return None
    return sum(run.guidance_ms) / len(run.guidance_ms)
