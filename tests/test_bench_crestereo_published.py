"""The published CREStereo as the benchmark's guide kind
``crestereo_published`` (``benchmark/guides/crestereo_published.py``) and
its plain reference (``benchmark/reference/crestereo_published.py``), on the
CPU: the kind's weights carry the published names and load into the port;
its check refuses other widths; its operation counts and the refinement's
least time are the tallies of ``torch.utils.flop_counter`` and of the
shapes; a tiny checkout with a ``crestereo_published`` configuration runs
``correct`` through the harness, where a constant guide fails the cell's
limits; the reference and the kind load nothing of the program; the
cell's three new metrics read nothing where no profiler ran.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from benchmark.harness import cell
from benchmark.harness.registry import Registry
from benchmark.tests.conftest import make_tiny
from tests.tiny_window import one_thread, window_seconds  # noqa: F401

from video3d_tpu_torch.models import crestereo as lite
from video3d_tpu_torch.models import crestereo_net as net

# thousands of small ops beside other workers (tests/tiny_window.py)
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
FULL = "crestereo_pub_k4_hsbs"  # the cell whose limits the tiny cell keeps
CONFIG = "crestereo_published_hybrid"
WINDOW_S = 6.0  # the least window; a run's is sized from its batch time
TINY = {k: (list(v) if isinstance(v, tuple) else v)
        for k, v in dataclasses.asdict(net.PublishedConfig.tiny()).items()
        if k != "dtype"}
TINY.update(kind="crestereo_published", conv_dtype="bfloat16",
            infer_scale_hd=2)
NEW_METRICS = ("crestereo_refine_ms_per_batch",
               "crestereo_refine_roofline_pct", "crestereo_agcl_ms_per_batch")


@pytest.fixture(scope="module")
def kind():
    return Registry().guide("crestereo_published")


@pytest.fixture(scope="module")
def ckpt(kind, tmp_path_factory) -> Path:
    return kind.weights(TINY, 2**31 + 3, tmp_path_factory.mktemp("pub"),
                        "cpu")


@pytest.mark.parametrize("widths", ["tiny", CONFIG])
def test_weights_have_the_published_names(kind, widths):
    """Names and shapes of the kind's table are the port's ``state_dict``
    (built without memory) at the tiny widths and at the
    configuration's; the published network has 6,055,188 parameters."""
    guide = TINY if widths == "tiny" else Registry().config(widths)["guide"]
    cfg = net.PublishedConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in guide.items()
                                 if k in kind.WIDTHS})
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in
                net.CREStereo(cfg).state_dict().items()}
    assert {k: shape for k, (shape, _) in kind.specs(guide).items()} == want
    if widths != "tiny":
        assert sum(torch.Size(s).numel() for s in want.values()) == 6055188


def test_seeded_weights_load_as_the_published_network(kind, ckpt, tmp_path):
    """The seeded file loads through the program's loader as the published
    network and passes the kind's check; the flow head's last conv carries
    its gain and drift; one seed writes the same tensors twice."""
    from safetensors.torch import load_file

    fn = lite.load_crestereo_guidance(ckpt, device="cpu")
    assert type(fn.module) is net.CREStereo and fn.stereo
    kind.check(fn, TINY)
    tensors = load_file(str(ckpt))
    assert {t.dtype for t in tensors.values()} == {torch.float32}
    assert float(tensors[kind.LAST_CONV + ".bias"][0]) == pytest.approx(
        -kind.FLOW_DRIFT, rel=1e-7)  # float32 of the drift
    assert float(tensors[kind.LAST_CONV + ".bias"][1]) == 0.0
    assert bool((tensors["self_att_fn.layers.0.norm1.weight"] == 1).all())
    again = load_file(str(kind.weights(TINY, 2**31 + 3, tmp_path, "cpu")))
    assert all(torch.equal(again[k], v) for k, v in tensors.items())


@pytest.mark.parametrize("change", [
    {"feat_dim": 64, "context_dim": 48}, {"hidden_dim": 8, "context_dim": 24},
    {"encoder_dims": [8, 12, 24]}, {"corr_dims": [24, 24]},
    {"head_dim": 32}, {"groups": 2}, {"nhead": 4}, {"iters": 10},
    {"conv_dtype": "float32"}])
def test_check_refuses_other_widths(kind, ckpt, change):
    fn = lite.load_crestereo_guidance(ckpt, device="cpu")
    with pytest.raises(RuntimeError, match="not the configuration's"):
        kind.check(fn, dict(TINY, **change))


def test_check_refuses_the_lite(kind):
    fn = lite.load_crestereo_guidance(device="cpu")
    with pytest.raises(RuntimeError, match="not the configuration's"):
        kind.check(fn, Registry().config(CONFIG)["guide"])


def _tally(fn) -> dict:
    """FlopCounterMode's operations of ``fn()`` by aten op."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as count:
        fn()
    return {str(k): v for k, v in count.get_flop_counts()["Global"].items()}


def test_work_is_the_flop_counters_tally(kind, ckpt):
    """One forward's count, both units, is ``FlopCounterMode``'s tally of
    the port's guidance call (its convolutions, linears and the linear
    attention's einsums) plus the correlation's products, counted by hand;
    the reference's tally adds the mask head at every step (the port
    computes it at each level's last) and ``cross_att_fn`` at each of its
    1/16 calls (the port once)."""
    g = dict(TINY, conv_dtype="float32")
    h, w = 96, 160  # below 720 rows: evaluation size 96x160
    ops = kind.work(g, h, w)
    eyes = torch.rand(1, h, w, 3) * 255.0
    port = lite.load_crestereo_guidance(ckpt, dtype=torch.float32,
                                        device="cpu")
    # the correlation by hand: 9 points x feat_dim products a position
    levels = [(3 * 5, 10), (6 * 10, 10), (12 * 20, 20), (24 * 40, 20)]
    corr = sum(2 * 9 * g["feat_dim"] * px * n for px, n in levels)
    assert kind.corr_flops(g, h, w) == corr
    assert sum(_tally(lambda: port(eyes, eyes)).values()) + corr \
        == ops["bf16"] + ops["f32"]
    reference = kind.reference(ckpt, g, "cpu", False)
    want = _tally(lambda: reference.guidance(eyes.double(), eyes.double(),
                                             "f64"))
    masks = sum((steps - 1) * (kind.step_flops(g, px, True)
                               - kind.step_flops(g, px, False))
                for px, steps in kind._levels(g, h, w))
    att = kind.attention_flops(g, h, w)
    cross = (g["iters"] // 2 - 1) * (att["bf16"] + att["f32"]) // 3
    assert sum(want.values()) + corr == (ops["bf16"] + ops["f32"] + masks
                                          + cross)


def test_refine_least_time_by_hand(kind):
    """At the cell's shape: 2 keyframes of the update steps' bf16
    operations at 989 TFLOP/s and the AGCL's maps at 3.35 TB/s, by hand
    from the published widths."""
    g = Registry().config(CONFIG)["guide"]
    hid, ctx = 128, 128
    mac = (36 * 256 + 256 * 192 * 9 + 2 * 128 * 49 + 128 * 64 * 9
           + 256 * 126 * 9 + 6 * (hid + ctx + 128) * hid * 5
           + hid * 256 * 9 + 256 * 2 * 9)
    mask = hid * 256 * 9 + 256 * 144
    levels = [(17 * 30, 10), (34 * 60, 10), (68 * 120, 20), (136 * 240, 20)]
    flops = sum(2 * px * (n * mac + mask) for px, n in levels)
    nbytes = sum(n * px * 4 * (2 * 256 + 36) for px, n in levels)
    want = 2 * (flops / 989e12 + nbytes / 3.35e12) * 1e3
    assert kind.refine_least_ms(g, 1080, 1920, 2) == pytest.approx(want)
    assert kind.refine_flops(g, 1080, 1920) == flops


def _tiny_pub(root: Path) -> Registry:
    """The tiny checkout with a ``crestereo_published`` configuration at
    the tiny widths (weights from a seed), at the default cadence, and
    its cell with the full cell's limits, as new files and entries."""
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / f"{CONFIG}.json").read_text())
    config.update(guide=TINY, weights={"seed": 2**31 + 5})
    (bench / "configs" / "tiny_pub.json").write_text(json.dumps(config))
    shutil.copy(bench / "workloads" / f"{FULL}.json",
                bench / "workloads" / "tiny_pub.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="tiny_pub", source="x", reduced=[],
                                file="benchmark/configs/tiny_pub.json",
                                why="x"))
    spec["workloads"].append(dict(name="tiny_pub", config="tiny_pub",
                                  traffic="tiny", chips=1, why="x"))
    full = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in full["end_to_end"] + full["per_layer"]
              if FULL in m.get("workloads", [])}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in listed:
            m["workloads"].append("tiny_pub")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Registry(root, bench)


@pytest.fixture
def tiny_pub(tmp_path, monkeypatch) -> Registry:
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return _tiny_pub(make_tiny(tmp_path / "checkout"))


def test_a_tiny_cell_is_correct(tiny_pub, kind):
    """Build (the program loads the seeded file through
    ``model_checkpoint`` and picks the network by its names; the kind
    checks it), the window, the reference and ``step_mfu``; the three new
    metrics read nothing where no profiler ran."""
    keep = {}
    out = cell.run(tiny_pub, "tiny_pub", 2**31 + 17,
                   window_seconds(tiny_pub, "tiny_pub", WINDOW_S), False,
                   "cpu", log=lambda m: None, keep=keep)
    assert out["correct"], out["checked"]
    run = keep["run"]
    assert run.keyframes == 1 and run.guide_work == kind.work(TINY, 32, 256)
    per_layer = {n: read for n, _, read in
                 tiny_pub.metrics("tiny_pub", "per_layer")}
    mfu = per_layer["step_mfu"]
    assert mfu(run) > mfu(type(run)(**dict(vars(run), keyframes=0))) > 0
    for name in NEW_METRICS:
        assert per_layer[name](run) is None


def test_a_constant_guide_fails_the_cells_limits(tiny_pub, monkeypatch):
    """The program with the network's two passes replaced by a constant
    disparity (10 px: inside the clip's range, where it agrees with the
    stereo in places) is not correct."""
    def constant(self, left, right):
        return torch.full((left.shape[0], *left.shape[-2:]), 10.0)

    monkeypatch.setattr(net.CREStereo, "infer", constant)
    out = cell.run(tiny_pub, "tiny_pub", 2**31 + 17,
                   window_seconds(tiny_pub, "tiny_pub", WINDOW_S), False,
                   "cpu", log=lambda m: None)
    assert not out["correct"], out["checked"]


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    """The reference and the kind import no module of the port, of the
    JAX package, of JAX or of a checkpoint library but safetensors."""
    code = ("import json, sys\n"
            "import benchmark.reference.crestereo_published\n"
            "import benchmark.harness.registry\n"
            "benchmark.harness.registry.Registry().guide("
            "'crestereo_published')\n"
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
                        "flax", "transformers", "megengine"}


def test_new_metrics_read_nothing_without_a_profiler():
    """Outside a profile the program records no span: each new metric
    returns None and raises nothing, as in a run of the parent."""
    from types import SimpleNamespace

    from benchmark.harness.registry import metric_reader

    run = SimpleNamespace(config=Registry().config(CONFIG), keyframes=2,
                          height=1080, eye_width=1920)
    for name in NEW_METRICS:
        read = metric_reader(ROOT / "benchmark" / "metrics" / f"{name}.py")
        assert read(run) is None
