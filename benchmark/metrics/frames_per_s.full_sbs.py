"""frames_per_s.full_sbs (host clock): frames_per_s in the full-SBS cells.
Their pinned upload (twice the bytes of a half-SBS batch) runs at a rate
that differs from process to process, so their rate has a bound of its
own."""

from pathlib import Path

from benchmark.harness.registry import metric_reader

read = metric_reader(Path(__file__).with_name("frames_per_s.py"))
