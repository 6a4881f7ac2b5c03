"""Fixtures of the benchmark's tests: a tiny copy of the benchmark in a
temporary checkout, whose cells run on the CPU (the program's plain twins)
in seconds.

Run from the checkout's root: ``python -m pytest benchmark/tests`` (CPU;
tests marked ``cuda`` skip without a card), ``python -m pytest
benchmark/tests -m cuda`` on the card.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the tiny mix: 32 rows, half-SBS 256 wide (eyes 128, unsqueezed to 256),
# 4 frames in batches of 2
TINY = dict(height=32, sbs_width=256, frames=4, batch=2, scenes=1)
# tiny cells and the full-size cell whose limits they are held to
TINY_CELLS = {"tiny_hybrid": ("crestereo_hybrid", "hybrid_k4_hsbs"),
              "tiny_stereo": ("stereo_sgbm", "stereo_hsbs")}


def make_tiny(dst: Path) -> Path:
    """A checkout at ``dst``: the benchmark's files plus a tiny traffic mix
    and tiny cells, the program linked in. Returns ``dst``."""
    from benchmark.harness.registry import BENCH_DIR

    bench = dst / "benchmark"
    for sub in ("configs", "traffic", "metrics", "workloads", "guides"):
        shutil.copytree(BENCH_DIR / sub, bench / sub)
    (dst / "video3d_tpu_torch").symlink_to(ROOT / "video3d_tpu_torch")
    mix = json.loads((bench / "traffic" / "hsbs.json").read_text())
    mix.update(TINY)
    (bench / "traffic" / "tiny.json").write_text(json.dumps(mix))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [dict(name=name, config=cfg, traffic="tiny", chips=1,
                              why="tiny CPU cell of the tests")
                         for name, (cfg, _) in TINY_CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:  # the tiny cells report what their full cells do
            m["workloads"] = [name for name, (_, full) in TINY_CELLS.items()
                              if full in m["workloads"]]
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    for name, (_, full) in TINY_CELLS.items():
        shutil.copy(bench / "workloads" / f"{full}.json",
                    bench / "workloads" / f"{name}.json")
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("tiny_checkout"))


@pytest.fixture
def own_tiny_root(tmp_path) -> Path:
    """A tiny checkout of the test's own, to add files to."""
    return make_tiny(tmp_path / "checkout")


@pytest.fixture(scope="session")
def tiny_reg(tiny_root):
    from benchmark.harness.registry import Registry

    return Registry(tiny_root, tiny_root / "benchmark")
