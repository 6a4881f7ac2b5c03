"""image_ms_per_batch.full_sbs (program span): image_ms_per_batch in the
full-SBS cells (no unsqueeze: the control of the half-SBS cells' GEMMs),
which report frames_per_s.full_sbs."""

from pathlib import Path

from benchmark.harness.registry import metric_reader

read = metric_reader(Path(__file__).with_name("image_ms_per_batch.py"))
