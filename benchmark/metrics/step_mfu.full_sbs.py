"""step_mfu.full_sbs (host clock): step_mfu in the full-SBS
cells, which report frames_per_s.full_sbs."""

from pathlib import Path

from benchmark.harness.registry import metric_reader

read = metric_reader(Path(__file__).with_name("step_mfu.py"))
