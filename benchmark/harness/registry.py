"""Finds what a cell is made of, by name, from files.

``BENCHMARK.json`` at the checkout's root lists the cells (configuration,
traffic, chips) and the metrics (unit, source, the cells they are read in).
Everything else is a file found by its name:

- a configuration: ``benchmark/configs/<config>.json``;
- a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``generator``
  names ``benchmark/traffic/<generator>.py`` (a ``render`` function);
- a cell's correctness limits: ``benchmark/workloads/<cell>.json``;
- a metric: ``benchmark/metrics/<metric>.py`` (a ``read`` function); a
  quantity split by the end-to-end metric its cells report
  (``<metric>.<variant>``) has a file of its own that may take its
  reader from the base metric's file (:func:`metric_reader`);
- a guide network: ``benchmark/guides/<kind>.py``, the ``kind`` that a
  configuration's ``guide`` names (see :meth:`Registry.guide`).

Adding any of them is adding files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"missing benchmark file: {path}")
    return json.loads(path.read_text())


def _load(path: Path):
    """The Python file at ``path`` as a module, loaded by path (a metric's
    name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"missing benchmark file: {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_file_{path.parent.name}_{path.stem.replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module(path: Path, attr: str):
    """``attr`` of the Python file at ``path``."""
    return getattr(_load(path), attr)


def metric_reader(path):
    """The ``read`` function of the metric file at ``path``."""
    return _module(Path(path), "read")


class Registry:
    """The benchmark as the files under ``bench_dir`` and ``root /
    BENCHMARK.json`` say."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.spec = _json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return _json(self.dir / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return _json(self.dir / "traffic" / f"{name}.json")

    def generator(self, name: str):
        return _module(self.dir / "traffic" / f"{name}.py", "render")

    def guide(self, kind: str):
        """The guide kind's file, ``benchmark/guides/<kind>.py``, as a
        module. It gives, for a configuration's ``guide`` dict:

        - ``weights(guide, seed, out, device)``: writes weights drawn from
          a ``torch.Generator`` seeded with ``seed`` into the directory
          ``out``, in the layout the program's loader reads, and returns
          the path to give the program (:mod:`benchmark.harness.weights`);
        - ``check(fn, guide)``: raises unless the program's resolved
          guidance fn has the guide's widths and precision;
        - ``reference(path, guide, device, control)``: the plain forward
          from the weights at ``path``, one precision lower with
          ``control``: an object with ``stereo`` (disparity out, or a
          monocular guide's relative depth) and ``guidance(left, right,
          image_mode)``, RGB eyes (B, H, W, 3) in [0, 255] -> (B, H, W)
          float64;
        - ``work(guide, h, w)``: ``{unit: operations}`` of one forward on
          eyes of (h, w), at the kind's own inference shape; ``unit`` is a
          key of :data:`benchmark.harness.work.PEAK_OPS_S`.
        """
        return _load(self.dir / "guides" / f"{kind}.py")

    def limits(self, cell: str) -> dict:
        return _json(self.dir / "workloads" / f"{cell}.json")["limits"]

    def metrics(self, cell: str, kind: str) -> list:
        """[(name, unit, read)] of the ``kind`` ("end_to_end" or
        "per_layer") metrics that ``cell`` reports."""
        out = []
        for m in self.spec[kind]:
            if "workloads" in m and cell not in m["workloads"]:
                continue
            out.append((m["name"], m["unit"],
                        _module(self.dir / "metrics" / f"{m['name']}.py",
                                "read")))
        return out
