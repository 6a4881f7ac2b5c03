"""matcher_ms_per_batch.full_sbs (program span): matcher_ms_per_batch in the
full-SBS cells, which report frames_per_s.full_sbs."""

from pathlib import Path

from benchmark.harness.registry import metric_reader

read = metric_reader(Path(__file__).with_name("matcher_ms_per_batch.py"))
