"""aggregate_roofline_pct (program span): the least times of kernels B2 and
B3 at the cell's shapes (bytes moved once at 3.35 TB/s, or operations at
the unit's peak, whichever is longer; B3 writes the margin where the blend
is ``confidence``) over the device time of the spans
``matcher.horizontal`` and ``matcher.vertical`` a batch: the SGM
aggregation's share of its roofline."""

from benchmark.harness import spans, work


def read(run):
    ms = spans.per_batch(("matcher.horizontal", "matcher.vertical"),
                         "device_ms")
    if not ms:
        return None
    guided = (run.config["guide"] is not None
              and run.config["extractor"]["blend"] == "confidence")
    kernels = work.matcher_work(run.batch, run.height, run.eye_width,
                                run.config["sgbm"]["num_disparities"],
                                guided)
    least = sum(work.least_ms(*kernels[k]) for k in ("B2", "B3"))
    return 100.0 * least / ms
