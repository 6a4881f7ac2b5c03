"""DPT-large as the benchmark's guide kind ``dpt_large``
(``benchmark/guides/dpt_large.py``) and its plain reference
(``benchmark/reference/dpt.py``), on the CPU at tiny widths.

The reference is held to HF ``DPTForDepthEstimation`` and the port's
``DPTDepthModel`` to the reference, on weights the kind writes from a seed;
the kind's table of names and shapes is HF's; its check refuses other
widths and other weights; its operation count is the tally of
``torch.utils.flop_counter`` over the reference's forward; and a tiny
checkout with a ``dpt_large`` configuration runs ``correct`` through the
harness, where a constant guide fails the cell's limits.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import cell, weights
from benchmark.harness.registry import Registry
from benchmark.tests.conftest import make_tiny
from tests.tiny_window import one_thread, window_seconds  # noqa: F401

from video3d_tpu_torch.models import dpt as tdpt

# thousands of small ops beside other workers (tests/tiny_window.py)
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
FULL = "dpt_hybrid_k1_hsbs"  # the cell whose limits the tiny cell keeps
# the tiny cell's least window: a batch takes ~0.2 s on 8 idle cores, and
# several times that beside the suite's other workers, so a run's window
# is sized from the batch time measured just before it
# (tests/tiny_window.py)
WINDOW_S = 6.0
TINY = dict(kind="dpt_large", image_size=384, patch_size=16, num_channels=3,
            hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
            intermediate_size=64, layer_norm_eps=1e-12,
            backbone_out_indices=[0, 1, 2, 3],
            neck_hidden_sizes=[16, 24, 32, 32], readout_type="project",
            reassemble_factors=[4, 2, 1, 0.5], fusion_hidden_size=16,
            dtype="bfloat16")


@pytest.fixture(scope="module")
def kind():
    return Registry().guide("dpt_large")


@pytest.fixture(scope="module")
def ckpt(kind, tmp_path_factory) -> Path:
    return kind.weights(TINY, 2**31 + 7, tmp_path_factory.mktemp("dpt"),
                        "cpu")


def _pixels(seed: int) -> torch.Tensor:
    """Normalised NCHW pixels at the inference square."""
    return torch.randn(2, 3, 384, 384,
                       generator=torch.Generator().manual_seed(seed))


def _no_tf(monkeypatch):
    """transformers without TensorFlow or flax, as a benchmark run has it
    (where it is imported first)."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    return pytest.importorskip("transformers")


def test_reference_matches_transformers(kind, ckpt, monkeypatch):
    """float32 on both sides; they differ in the order of sums only (HF's
    attention and interpolation against the reference's products with the
    interpolation matrices), so the tolerance is the one
    tests/test_torch_dpt.py holds the port's float32 DPT to HF with. HF
    reads the kind's config.json and model.safetensors as they are."""
    transformers = _no_tf(monkeypatch)
    hf = transformers.DPTForDepthEstimation.from_pretrained(str(ckpt))
    assert {p.dtype for p in hf.parameters()} == {torch.float32}
    x = _pixels(1)
    with torch.no_grad():
        want = hf.eval()(pixel_values=x).predicted_depth
    got = kind.reference(ckpt, TINY, "cpu", False).forward(x)
    assert got.shape == want.shape == (2, 384, 384)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                               atol=2e-4)
    # not degenerate: the last ReLU clips next to nothing, the map varies
    assert float((want > 0).double().mean()) > 0.99
    assert float(want.std(dim=(-2, -1)).min()) > 0.05 * float(want.mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_matches_reference(kind, ckpt, dtype):
    """The port's DPT through its loader against the reference. float32:
    HF's tolerance above. bfloat16 (the configuration's weights and
    input): the port keeps bfloat16 through the backbone and neck and
    rounds at every layer where the reference stays float32, so the output
    is held to 3% of its range at most and 1% in the median, the bounds
    tests/test_torch_dpt.py holds the bfloat16 port to the JAX model with."""
    net = kind.reference(ckpt, TINY, "cpu", False)
    fn = tdpt.load_dpt_safetensors(str(ckpt), dtype=dtype,
                                   device="cpu")
    x = _pixels(2)
    want = net.forward(x)
    got = fn.module(x.permute(0, 2, 3, 1).to(dtype))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                                   atol=2e-4)
        # the guidance fn with its resizes (float32 against float64)
        eye = torch.from_numpy(np.random.default_rng(3).uniform(
            0, 255, (2, 40, 96, 3)))
        np.testing.assert_allclose(
            fn(eye.float()).numpy(),
            net.guidance(eye, None, "f64").numpy(), rtol=1e-3, atol=2e-4)
        return
    err = (got - want).abs()
    span = float(want.abs().max())
    assert float(err.max()) <= 0.03 * span, (float(err.max()), span)
    assert float(err.median()) <= 0.01 * span


@pytest.mark.parametrize("widths", ["tiny", "dpt_large_hybrid"])
def test_weight_table_is_transformers(kind, widths, monkeypatch):
    """Names and shapes of the kind's checkpoint, against HF's model built
    from the kind's config.json (without memory), at the tiny widths and
    at the configuration's own."""
    transformers = _no_tf(monkeypatch)
    guide = (TINY if widths == "tiny"
             else Registry().config(widths)["guide"])
    with torch.device("meta"):
        hf = transformers.DPTForDepthEstimation(
            transformers.DPTConfig(**kind.hf_config(guide)))
    want = {k: tuple(v.shape) for k, v in hf.state_dict().items()}
    assert {k: shape for k, (shape, _) in kind.specs(guide).items()} == want
    if widths != "tiny":  # DPT-large: about 343 M parameters
        assert 342e6 < sum(np.prod(s) for s in want.values()) < 344e6


def _digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_seeded_weights_are_the_seeds(kind, tmp_path, monkeypatch):
    """One seed writes the same bytes twice (again after the directory is
    gone), another seed other bytes; bfloat16 throughout."""
    from safetensors.torch import load_file

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    reg = Registry()
    config = dict(reg.config("dpt_large_hybrid"), guide=TINY,
                  weights={"seed": 2**33})
    first = weights.path(kind, config, reg.root, "cpu")
    assert first.is_dir() and tmp_path in first.parents
    digest = _digest(first / "model.safetensors")
    shutil.rmtree(weights.work_dir())
    again = weights.path(kind, config, reg.root, "cpu")
    assert _digest(again / "model.safetensors") == digest
    assert json.loads((again / "config.json").read_text())["hidden_size"] \
        == TINY["hidden_size"]
    other = weights.path(kind, dict(config, weights={"seed": 2**33 + 1}),
                         reg.root, "cpu")
    assert _digest(other / "model.safetensors") != digest
    tensors = load_file(str(again / "model.safetensors"))
    assert {t.dtype for t in tensors.values()} == {torch.bfloat16}
    assert bool((tensors["dpt.layernorm.weight"] == 1).all())
    assert float(tensors["head.head.4.bias"].abs().sum()) > 0


@pytest.fixture(scope="module")
def programs(ckpt):
    return {dt: tdpt.load_dpt_safetensors(str(ckpt), dtype=dt, device="cpu")
            for dt in (torch.bfloat16, torch.float32)}


@pytest.mark.parametrize("change", [
    {}, {"hidden_size": 64}, {"num_hidden_layers": 3},
    {"num_attention_heads": 4}, {"intermediate_size": 128},
    {"neck_hidden_sizes": [16, 24, 32, 64]}, {"fusion_hidden_size": 32},
    {"backbone_out_indices": [0, 1, 2, 2]}, {"dtype": "float32"},
    {"image_size": 64}])
def test_check_refuses_other_widths_and_weights(kind, programs, change):
    """The bfloat16 program at the tiny widths passes the tiny guide's
    check and no other; float32 weights fail it."""
    guide = dict(TINY, **change)
    if not change:
        kind.check(programs[torch.bfloat16], guide)
        with pytest.raises(RuntimeError, match="not the configuration's"):
            kind.check(programs[torch.float32], guide)
        return
    with pytest.raises(RuntimeError, match="not the configuration's"):
        kind.check(programs[torch.bfloat16], guide)


def test_the_configuration_is_what_the_program_runs(kind):
    """The configuration's matcher is ``SGBMParams()``, nothing is cut, its
    weights come from a seed, and config.json of its guide, read by the
    port's DPTConfig.from_hf, is DPT-large: a bfloat16 network of it
    (built without memory) passes the kind's check."""
    import dataclasses

    from video3d_tpu_torch.models.guidance import GuidanceFn
    from video3d_tpu_torch.ops.stereo import SGBMParams

    config = Registry().config("dpt_large_hybrid")
    assert config["sgbm"] == dataclasses.asdict(SGBMParams())
    assert config["reduced"] == [] and set(config["weights"]) == {"seed"}
    assert config["extractor"]["guidance"] == "dpt"
    guide = config["guide"]
    cfg = tdpt.DPTConfig.from_hf(kind.hf_config(guide))
    assert cfg == tdpt.DPTConfig.dpt_large()
    kind.check(GuidanceFn(None, tdpt._skeleton(cfg).to(torch.bfloat16)),
               guide)


def test_work_is_the_flop_counters_tally(kind, ckpt):
    """The kind's count of one forward, times the keyframes, equals
    ``FlopCounterMode``'s tally of the reference's guidance call and of
    the port's float32 one on the same eyes: every product is counted
    (bias adds and element-wise steps are in neither); no term is left
    for a count by hand."""
    from torch.utils.flop_counter import FlopCounterMode

    eyes = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 255, (3, 40, 96, 3)))
    ops = kind.work(TINY, 40, 96)
    assert set(ops) == {"bf16", "tf32", "f32"} and min(ops.values()) > 0
    net = kind.reference(ckpt, TINY, "cpu", False)
    with FlopCounterMode(display=False) as ref_count:
        net.guidance(eyes, None, "f64")
    fn = tdpt.load_dpt_safetensors(str(ckpt), dtype=torch.float32,
                                   device="cpu")
    with FlopCounterMode(display=False) as port_count:
        fn(eyes.float())
    total = 3 * sum(ops.values())
    assert ref_count.get_total_flops() == total
    assert port_count.get_total_flops() == total
    # the backbone's share, which dpt_backbone_roofline_pct reads
    with FlopCounterMode(display=False) as vit:
        fn.module.backbone(_pixels(5).permute(0, 2, 3, 1))
    assert vit.get_total_flops() == 2 * kind.backbone_flops(TINY)


def test_attention_least_time():
    """B7's least time at DPT-large's (8, 16, 577, 64) in bfloat16: the
    bytes bound it (11.29 us a call), 24 calls a forward."""
    guide = Registry().config("dpt_large_hybrid")["guide"]
    kind = Registry().guide("dpt_large")
    per_call = 4 * 8 * 577 * 1024 * 2 / 3.35e12 * 1e3
    assert kind.attention_least_ms(guide, 8) == pytest.approx(24 * per_call)
    assert 4 * 8 * 577**2 * 1024 / 989e12 * 1e3 < per_call


def _tiny_dpt(root: Path) -> Registry:
    """The tiny checkout with a ``dpt_large`` configuration at the tiny
    widths (weights from a seed), its guide on every frame, and its cell
    with the full cell's limits, as new files and entries."""
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / "dpt_large_hybrid.json")
                        .read_text())
    config.update(guide=TINY, weights={"seed": 2**31 + 5})
    (bench / "configs" / "tiny_dpt.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic" / "tiny.json").read_text())
    mix["options"] = {"guidance_every": 1}
    (bench / "traffic" / "tiny_k1.json").write_text(json.dumps(mix))
    shutil.copy(bench / "workloads" / f"{FULL}.json",
                bench / "workloads" / "tiny_dpt.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="tiny_dpt", source="x", reduced=[],
                                file="benchmark/configs/tiny_dpt.json",
                                why="x"))
    spec["workloads"].append(dict(name="tiny_dpt", config="tiny_dpt",
                                  traffic="tiny_k1", chips=1, why="x"))
    full = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in full["end_to_end"] + full["per_layer"]
              if FULL in m.get("workloads", [])}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in listed:
            m["workloads"].append("tiny_dpt")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Registry(root, bench)


@pytest.fixture
def tiny_dpt(tmp_path, monkeypatch) -> Registry:
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return _tiny_dpt(make_tiny(tmp_path / "checkout"))


def test_a_tiny_dpt_cell_is_correct(tiny_dpt, kind):
    """Build (the program loads the seeded directory through
    ``model_checkpoint`` and the kind checks it), the window, the
    reference and ``step_mfu``."""
    keep = {}
    out = cell.run(tiny_dpt, "tiny_dpt", 2**31 + 17,
                   window_seconds(tiny_dpt, "tiny_dpt", WINDOW_S), False,
                   "cpu", log=lambda m: None, keep=keep)
    assert out["correct"], out["checked"]
    run = keep["run"]
    assert run.keyframes == 2 and run.guide_work == kind.work(TINY, 32, 256)
    per_layer = {n: read for n, _, read in
                 tiny_dpt.metrics("tiny_dpt", "per_layer")}
    mfu = per_layer["step_mfu"]
    assert mfu(run) > mfu(type(run)(**dict(vars(run), keyframes=0))) > 0
    # no profiler ran: the DPT metrics read nothing and raise nothing
    for name in ("dpt_backbone_ms_per_batch", "dpt_decoder_ms_per_batch",
                 "dpt_backbone_roofline_pct", "attention_roofline_pct"):
        assert per_layer[name](run) is None


def test_a_constant_guide_fails_the_cells_limits(tiny_dpt, monkeypatch):
    """The program with its guide's output replaced by a constant map (the
    landing then puts the confident stereo's mean everywhere the blend
    trusts the guide) is not correct."""
    def constant(self, pixels):
        return torch.ones(pixels.shape[0], *pixels.shape[1:3])

    monkeypatch.setattr(tdpt.DPTDepthModel, "forward", constant)
    out = cell.run(tiny_dpt, "tiny_dpt", 2**31 + 17,
                   window_seconds(tiny_dpt, "tiny_dpt", WINDOW_S), False,
                   "cpu", log=lambda m: None)
    assert not out["correct"], out["checked"]


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    """The reference and the kind import no module of the port, of the
    JAX package, of JAX or of transformers."""
    code = ("import json, sys\n"
            "import benchmark.reference.dpt, benchmark.harness.registry\n"
            "benchmark.harness.registry.Registry().guide('dpt_large')\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in names and "benchmark" in names
    assert not names & {"video3d_tpu_torch", "video3d_tpu", "jax", "jaxlib",
                        "flax", "transformers"}
