"""The benchmark's files: every configuration, traffic mix, generator,
cell limit and metric that BENCHMARK.json names is found by name and parses,
the file keeps to the contract's shape, and a cell can be added as new files
without editing any existing one."""

from __future__ import annotations

import hashlib
import json
import re
import shutil

import pytest

from benchmark.harness.registry import BENCH_DIR, ROOT, Registry

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    reg = Registry()
    w = reg.cell(cell)
    config = reg.config(w["config"])
    traffic = reg.traffic(w["traffic"])
    assert callable(reg.generator(traffic["generator"]))
    limits = reg.limits(cell)
    assert limits and all(v > 0 for v in limits.values())
    assert {"extractor", "sgbm", "guide", "weights"} <= set(config)
    e2e = [m for m, _, _ in reg.metrics(cell, "end_to_end")]
    per_layer = [m for m, _, _ in reg.metrics(cell, "per_layer")]
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) \
        == len(CELLS)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        reported = [n for n, m in e2e.items()
                    if cell in m.get("workloads", CELLS)]
        assert "setup_s" in reported and len(reported) >= 2
    for m in SPEC["per_layer"]:
        # each cell that reads the metric reports the one it moves
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", CELLS))
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_is_what_the_program_runs(name):
    """The configuration file's matcher and guide are the program's
    defaults (StereoDepthExtractor() and --stereo-only)."""
    import dataclasses

    from video3d_tpu_torch.models.crestereo import CREStereoConfig
    from video3d_tpu_torch.ops.stereo import SGBMParams

    config = Registry().config(name)
    assert config["sgbm"] == dataclasses.asdict(SGBMParams())
    assert config["reduced"] == []
    if config["guide"] is not None:
        cfg = dataclasses.asdict(CREStereoConfig())
        cfg.pop("dtype")
        assert config["guide"]["kind"] == "crestereo_lite"
        assert {k: config["guide"][k] for k in cfg} == cfg
        assert (ROOT / config["weights"]).is_file()


def _digest(root) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
        if p.is_file()}


def test_cell_added_as_new_files(tmp_path):
    """A configuration, a traffic mix, a cell's limits and a metric added as
    new files (and entries in BENCHMARK.json) load by name; no existing
    file of the benchmark changes."""
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "workloads", "guides"):
        shutil.copytree(BENCH_DIR / sub, bench / sub)
    before = _digest(bench)
    cfg = json.loads((bench / "configs" / "stereo_sgbm.json").read_text())
    cfg["sgbm"]["num_paths"] = 8
    (bench / "configs" / "stereo_hh.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "hsbs.json").read_text())
    mix["frames"] = 32
    (bench / "traffic" / "hsbs_short.json").write_text(json.dumps(mix))
    (bench / "workloads" / "stereo_hh_hsbs.json").write_text(
        json.dumps({"limits": {"mean_px": 0.002}}))
    (bench / "metrics" / "batches_a_s.py").write_text(
        "def read(run):\n    return run.batches / run.seconds\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="stereo_hh", source="x",
                                file="benchmark/configs/stereo_hh.json",
                                reduced=[], why="x"))
    spec["workloads"].append(dict(name="stereo_hh_hsbs", config="stereo_hh",
                                  traffic="hsbs_short", chips=1, why="x"))
    spec["per_layer"].append(dict(name="batches_a_s", unit="1/s",
                                  better="higher", source="host_clock",
                                  layer="stage", moves="frames_per_s",
                                  workloads=["stereo_hh_hsbs"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    reg = Registry(tmp_path, bench)
    w = reg.cell("stereo_hh_hsbs")
    assert reg.config(w["config"])["sgbm"]["num_paths"] == 8
    assert reg.traffic(w["traffic"])["frames"] == 32
    assert reg.limits("stereo_hh_hsbs") == {"mean_px": 0.002}
    metrics = {n: read for n, _, read in reg.metrics("stereo_hh_hsbs",
                                                     "per_layer")}
    assert metrics["batches_a_s"](type("R", (), dict(batches=20,
                                                     seconds=10.0))) == 2.0
    assert "batches_a_s" not in [n for n, _, _ in
                                 reg.metrics("stereo_hsbs", "per_layer")]
    after = _digest(bench)
    assert {k: after[k] for k in before} == before


def test_unknown_names_fail_loudly(tiny_reg):
    with pytest.raises(KeyError):
        tiny_reg.cell("no_such_cell")
    with pytest.raises(FileNotFoundError):
        tiny_reg.config("no_such_config")
    with pytest.raises(FileNotFoundError):
        tiny_reg.limits("no_such_cell")
