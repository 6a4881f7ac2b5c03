"""aggregate_roofline_pct.full_sbs (program span): aggregate_roofline_pct in
the full-SBS cells, which report frames_per_s.full_sbs."""

from pathlib import Path

from benchmark.harness.registry import metric_reader

read = metric_reader(Path(__file__).with_name("aggregate_roofline_pct.py"))
