"""matcher_roofline_pct (program span): the sum of kernels B1-B4's least
times at the cell's shapes (bytes moved once at 3.35 TB/s, or operations
at the unit's peak, whichever is longer) over matcher_ms_per_batch."""

from benchmark.harness import work


def read(run):
    if not run.matcher_ms:
        return None
    ms = sum(run.matcher_ms) / len(run.matcher_ms)
    guided = (run.config["guide"] is not None
              and run.config["extractor"]["blend"] == "confidence")
    least = work.matcher_least_ms(run.batch, run.height, run.eye_width,
                                  run.config["sgbm"]["num_disparities"],
                                  guided)
    return 100.0 * least / ms
