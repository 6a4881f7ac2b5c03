"""Guide networks found by name: a configuration's ``guide`` names its kind,
and ``benchmark/guides/<kind>.py`` gives the weights, the check of what the
program loaded, the plain forward and the operation count. A second kind
(a monocular guide) runs a tiny cell as new files alone, and the reference
lands a monocular guide as the port's ``guidance_blend`` does."""

from __future__ import annotations

import hashlib
import json
import shutil
import tempfile
from pathlib import Path

import pytest
import torch

from benchmark.harness import cell, check, weights, work
from benchmark.harness.registry import Registry
from benchmark.reference.depth import blend, to_uint16

HERE = Path(__file__).resolve().parent

# one step's least time at the published peaks, ms: the yardstick's value
# before the guide's count moved into its kind's file, to the last bit
PINNED = {"hybrid_k4_hsbs": 1.4967634904547031,
          "hybrid_k1_hsbs": 2.5026631797292604,
          "stereo_hsbs": 1.1614635940298506,
          "stereo_fsbs": 1.1614635940298506}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_step_least_ms_is_unchanged(name):
    reg = Registry()
    w = reg.cell(name)
    config, traffic = reg.config(w["config"]), reg.traffic(w["traffic"])
    h, batch = traffic["height"], traffic["batch"]
    eye = traffic["sbs_width"] // (1 if traffic["format"] == "half_sbs"
                                   else 2)
    every = dict(config["extractor"], **traffic["options"])["guidance_every"]
    guide = config["guide"]
    keyframes = -(-batch // every) if guide is not None else 0
    guide_work = (reg.guide(guide["kind"]).work(guide, h, eye)
                  if guide is not None else None)
    assert work.step_least_ms(batch, h, eye,
                              config["sgbm"]["num_disparities"], keyframes,
                              guide_work) == PINNED[name]


def test_missing_kind_names_its_file():
    with pytest.raises(FileNotFoundError, match=r"guides/no_such_kind\.py"):
        Registry().guide("no_such_kind")


@pytest.mark.parametrize("change, loads", [
    ({}, True), ({"feat_dim": 32}, False), ({"iters": 3}, False),
    ({"conv_dtype": "float32"}, False)])
def test_crestereo_lite_checks_widths_and_precision(change, loads):
    from video3d_tpu_torch.models.crestereo import (BUNDLED_WEIGHTS,
                                                    load_crestereo_guidance)

    reg = Registry()
    kind = reg.guide("crestereo_lite")
    guide = dict(reg.config("crestereo_hybrid")["guide"], **change)
    fn = load_crestereo_guidance(BUNDLED_WEIGHTS, device="cpu")
    if loads:
        kind.check(fn, guide)
    else:
        with pytest.raises(RuntimeError, match="not the configuration's"):
            kind.check(fn, guide)


def _digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_seeded_weights_are_the_seeds(tmp_path, monkeypatch):
    """One seed writes the same bytes twice, another other bytes; a second
    look in the same TMPDIR finds them written; the program loads them and
    its kind's check passes; the reference reads the same tensors."""
    from safetensors.torch import load_file

    from video3d_tpu_torch.models.crestereo import load_crestereo_guidance

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    reg = Registry()
    kind = reg.guide("crestereo_lite")
    config = dict(reg.config("crestereo_hybrid"), weights={"seed": 2**33})
    first = weights.path(kind, config, reg.root, "cpu")
    assert first.is_file() and tmp_path in first.parents
    bytes_first, mtime = _digest(first), first.stat().st_mtime_ns
    assert weights.path(kind, config, reg.root, "cpu") == first
    assert first.stat().st_mtime_ns == mtime  # found, not written again
    shutil.rmtree(weights.work_dir())
    again = weights.path(kind, config, reg.root, "cpu")
    assert _digest(again) == bytes_first
    other = weights.path(kind, dict(config, weights={"seed": 2**33 + 1}),
                         reg.root, "cpu")
    assert other != again and _digest(other) != bytes_first

    fn = load_crestereo_guidance(str(again), device="cpu")
    kind.check(fn, config["guide"])
    net = kind.reference(again, config["guide"], "cpu", False)
    program = fn.module.state_dict()
    for k, v in load_file(str(again)).items():
        assert torch.equal(net.w[k], v) and torch.equal(program[k], v)


def _tiny_mono(root: Path) -> Registry:
    """The tiny checkout with a monocular guide kind, its configuration
    (weights from a seed), its cell and the cell's limits, as new files and
    entries; returns its registry."""
    bench = root / "benchmark"
    shutil.copy(HERE / "kind_tiny_dpt.py", bench / "guides" / "tiny_dpt.py")
    config = json.loads((bench / "configs" / "crestereo_hybrid.json")
                        .read_text())
    config["extractor"]["guidance"] = "dpt"
    config["weights"] = {"seed": 2**31 + 5}
    config["guide"] = dict(
        kind="tiny_dpt", image_size=64, patch_size=16, hidden_size=32,
        num_hidden_layers=4, num_attention_heads=2, intermediate_size=64,
        backbone_out_indices=[0, 1, 2, 3], neck_hidden_sizes=[16, 24, 32, 32],
        fusion_hidden_size=16, dtype="bfloat16")
    (bench / "configs" / "tiny_mono.json").write_text(json.dumps(config))
    shutil.copy(bench / "workloads" / "tiny_hybrid.json",
                bench / "workloads" / "tiny_mono.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="tiny_mono", source="x", reduced=[],
                                file="benchmark/configs/tiny_mono.json",
                                why="x"))
    spec["workloads"].append(dict(name="tiny_mono", config="tiny_mono",
                                  traffic="tiny", chips=1, why="x"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tiny_hybrid" in m.get("workloads", []):
            m["workloads"].append("tiny_mono")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Registry(root, bench)


def test_a_second_kind_runs_as_new_files(own_tiny_root, monkeypatch,
                                         tmp_path):
    """Build, window, reference and step_mfu of a cell whose guide is a
    monocular kind that only new files bring; no file of the benchmark
    changes."""
    # as a run sets them: transformers loads neither JAX nor TensorFlow
    monkeypatch.setenv("USE_FLAX", "0")
    monkeypatch.setenv("USE_TF", "0")
    pytest.importorskip("transformers")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    bench = own_tiny_root / "benchmark"
    before = {p: _digest(p) for p in bench.rglob("*") if p.is_file()}
    reg = _tiny_mono(own_tiny_root)
    keep = {}
    out = cell.run(reg, "tiny_mono", 2**31 + 17, 3.0, False, "cpu",
                   log=lambda m: None, keep=keep)
    assert out["correct"], out["checked"]
    assert {p: _digest(p) for p in before} == before
    step_mfu = dict((n, read) for n, _, read in
                    reg.metrics("tiny_mono", "per_layer"))["step_mfu"]
    assert keep["run"].keyframes == 1 and keep["run"].guide_work["bf16"] > 0
    assert step_mfu(keep["run"]) > step_mfu(
        type(keep["run"])(**dict(vars(keep["run"]), keyframes=0)))


def _mono_scene(seed: int):
    """A stereo disparity with a confident part and a low-confidence block
    where it is wrong, and a monocular guide that is an affine map of the
    true disparity (another per image) plus a little noise."""
    g = torch.Generator().manual_seed(seed)
    b, h, w = 2, 48, 96
    ys = torch.linspace(0.0, 1.0, h)[:, None]
    xs = torch.linspace(0.0, 1.0, w)[None, :]
    truth = torch.stack([8.0 + 30.0 * xs * (0.5 + 0.5 * ys),
                         36.0 - 24.0 * ys + 4.0 * xs])
    disp = truth + 0.2 * torch.randn(b, h, w, generator=g, dtype=torch.float64)
    conf = 0.5 + 0.5 * torch.rand(b, h, w, generator=g, dtype=torch.float64)
    disp[:, 10:30, 20:60] += 12.0  # wrong where the matcher is unsure
    conf[:, 10:30, 20:60] = 0.02
    scale = torch.tensor([3.0, 0.5], dtype=torch.float64)[:, None, None]
    shift = torch.tensor([50.0, -2.0], dtype=torch.float64)[:, None, None]
    mono = (truth * scale + shift
            + 0.05 * torch.randn(b, h, w, generator=g, dtype=torch.float64))
    return disp, conf, mono


def _port_maps(disp, conf, mono, config, blend_mode):
    from video3d_tpu_torch.ops.stereo import SGBMParams
    from video3d_tpu_torch.stages import depth as stage

    ext = config["extractor"]
    eyes = torch.zeros(*disp.shape, 3)
    out = stage.guidance_blend(
        disp.float(), conf.float(), eyes, eyes, lambda left: mono.float(),
        SGBMParams(**config["sgbm"]), guidance_every=1,
        stereo_weight=ext["stereo_weight"], blend=blend_mode,
        trust_scale=ext["trust_scale"])
    return stage.disparity_to_uint16(out, config["sgbm"]["num_disparities"])


def _reference_maps(disp, conf, mono, config, blend_mode):
    ext = dict(config["extractor"], blend=blend_mode)
    out = blend(disp, conf, mono, False, ext, config["sgbm"])
    return to_uint16(out, config["sgbm"]["num_disparities"], "fixed")


@pytest.mark.parametrize("blend_mode", ["confidence", "fixed"])
@pytest.mark.parametrize("seed", [2**31 + 1, 2**33 + 3])
def test_mono_blend_holds_to_the_ports(tiny_reg, blend_mode, seed):
    """The float64 landing and blend of a monocular guide against the
    port's float32 ``guidance_blend``, within the tiny hybrid's limits."""
    config = tiny_reg.config("crestereo_hybrid")
    disp, conf, mono = _mono_scene(seed)
    ref = _reference_maps(disp, conf, mono, config, blend_mode)
    got = check.numbers(_port_maps(disp, conf, mono, config, blend_mode),
                        ref, config["sgbm"]["num_disparities"])
    assert check.verdict(got, tiny_reg.limits("tiny_hybrid"))[0], got
    # the guide decides the unsure block: the fit lands it on the truth
    if blend_mode == "confidence":
        unsure = ref[:, 10:30, 20:60].double() * 64 / 65535.0
        assert (unsure - disp[:, 10:30, 20:60]).abs().mean() > 8.0


def test_a_program_without_the_fit_fails(tiny_reg, monkeypatch):
    """The port with the scale-and-shift fit left out (every fit rejected,
    so the min-max guide stands) fails the tiny hybrid's limits."""
    from video3d_tpu_torch.stages import depth as stage

    def no_fit(pred, target, valid):
        ones = torch.ones(pred.shape[0], 1, 1)
        return -ones, 0.0 * ones

    monkeypatch.setattr(stage, "ssi_align", no_fit)
    config = tiny_reg.config("crestereo_hybrid")
    disp, conf, mono = _mono_scene(2**31 + 1)
    got = check.numbers(_port_maps(disp, conf, mono, config, "confidence"),
                        _reference_maps(disp, conf, mono, config,
                                        "confidence"),
                        config["sgbm"]["num_disparities"])
    assert not check.verdict(got, tiny_reg.limits("tiny_hybrid"))[0], got
