"""peak_mem_gib.full_sbs (program counter): peak_mem_gib in the full-SBS
cells, which report frames_per_s.full_sbs."""

from pathlib import Path

from benchmark.harness.registry import metric_reader

read = metric_reader(Path(__file__).with_name("peak_mem_gib.py"))
