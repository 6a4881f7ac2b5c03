"""The port's image ops and stereo-only depth stage vs the JAX package.

Same numpy inputs (fixed seeds) go to both. The JAX stage runs its f32
XLA matcher on CPU (unrounded costs, BIG out-of-frame sentinel) while the
port runs the int16 formulation the TPU path ships, so whole-stage
comparisons use the ROADMAP C5 tolerance: validity flips on < 2% of
pixels, |dd| < 0.25 on > 98% of pixels valid in both, median |dd| < 0.05.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_test_video
from video3d_tpu.ops import image as jimage
from video3d_tpu.ops.stereo import SGBMParams as JaxParams
from video3d_tpu.stages import depth as jdepth
from video3d_tpu_torch.ops import image as timage
from video3d_tpu_torch.ops.stereo import SGBMParams, sgbm_params_from_jax
from video3d_tpu_torch.stages import depth as tdepth

REPO = Path(__file__).resolve().parents[1]


def assert_c5(a: np.ndarray, b: np.ndarray, valid_a, valid_b,
              min_valid: float = 0.3) -> None:
    """ROADMAP C5 agreement of two disparity (or depth) maps."""
    assert (valid_a != valid_b).mean() < 0.02
    both = valid_a & valid_b
    assert both.mean() >= min_valid
    if not both.any():
        return
    d = np.abs(a - b)[both]
    assert (d < 0.25).mean() > 0.98, f"agree={(d < 0.25).mean()}"
    assert np.median(d) < 0.05


def test_port_is_jax_free_and_params_pinned():
    """Every module of the port, and chip_smoke.py, imports with
    ``video3d_tpu`` made unimportable and without importing jax."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "video3d_tpu_torch").rglob("*.py")
        if p.name != "__init__.py" or p.parent.name != "video3d_tpu_torch")
    code = (
        "import importlib, sys\n"
        "sys.modules['video3d_tpu'] = None  # any import of it now fails\n"
        f"for name in {modules!r} + ['video3d_tpu_torch', 'chip_smoke']:\n"
        "    importlib.import_module(name.removesuffix('.__init__'))\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert callable(sys.modules['chip_smoke'].main)\n"
        "print('ok')\n"
    )
    assert "video3d_tpu_torch.cli.depth" in modules
    assert "video3d_tpu_torch.core.video" in modules
    assert "video3d_tpu_torch.kernels.wmajor" in modules
    assert "video3d_tpu_torch.tools.probe_i16" in modules
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    blocked = subprocess.run(
        [sys.executable, "-c", "import sys\nsys.modules['video3d_tpu'] = "
         "None\nimport video3d_tpu.core"], cwd=REPO, capture_output=True,
        text=True, timeout=60)
    assert blocked.returncode != 0  # the block itself works
    # imports inside functions run only when called: read every import
    # statement of the port, of chip_smoke.py and of the card tests, which
    # run on a machine without jax
    import ast

    for path in [REPO / "chip_smoke.py", REPO / "tests/test_torch_card.py",
                 REPO / "tests/test_torch_card_paths.py",
                 *(REPO / "video3d_tpu_torch").rglob("*.py")]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "video3d_tpu"), (
                    f"{path.relative_to(REPO)} imports {name}")
    ported = sgbm_params_from_jax(dataclasses.asdict(JaxParams()))
    for f in dataclasses.fields(SGBMParams):
        assert getattr(ported, f.name) == getattr(SGBMParams(), f.name), f.name
    assert [f.name for f in dataclasses.fields(SGBMParams)] == [
        f.name for f in dataclasses.fields(JaxParams)]


@pytest.mark.parametrize("n_in,n_out,method", [
    (48, 96, "lanczos4"), (960, 1920, "lanczos4"), (37, 20, "bilinear")])
def test_resample_matrix_equal(n_in, n_out, method):
    np.testing.assert_array_equal(
        timage.resample_matrix(n_in, n_out, method),
        jimage.resample_matrix(n_in, n_out, method))


def test_image_ops_match_jax():
    r = np.random.default_rng(0)
    frames = r.integers(0, 256, (2, 12, 64, 3)).astype(np.uint8)
    jl, jr = jimage.split_sbs(jnp.asarray(frames))
    tl, tr = timage.split_sbs(torch.from_numpy(frames))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(
        timage.rgb_to_gray(torch.from_numpy(frames)).numpy(),
        np.asarray(jimage.rgb_to_gray(jnp.asarray(frames))), atol=1e-3)
    planes = r.uniform(0, 255, (2, 3, 12, 32)).astype(np.float32)
    # summation order of the matmul differs: atol 1e-3 on the 0-255 scale
    np.testing.assert_allclose(
        timage.unsqueeze_width(torch.from_numpy(planes)).numpy(),
        np.asarray(jimage.unsqueeze_width(jnp.asarray(planes))), atol=1e-3)


def _sbs_frames(seed, b=2, h=32, w_eye=64, shift=3):
    """SBS uint8 RGB frames whose right eye is the left shifted by
    ``shift`` eye pixels (2*shift after the unsqueeze). The texture is
    random at a 2-pixel grain: per-pixel noise at this tiny size makes the
    uniqueness test a coin toss for either formulation."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 256, (b, h // 2, (w_eye + shift + 1) // 2, 3))
    base = np.repeat(np.repeat(base, 2, 1), 2, 2)[:, :h, :w_eye + shift]
    base = base.astype(np.uint8)
    left = base[:, :, :w_eye]
    right = base[:, :, shift:shift + w_eye]
    return np.ascontiguousarray(np.concatenate([left, right], axis=2))


@pytest.mark.parametrize("unsqueeze", [True, False])
def test_depth_batch_pipeline_matches_jax(unsqueeze):
    frames = _sbs_frames(1)
    p = SGBMParams(num_disparities=16)
    jp = JaxParams(num_disparities=16)
    want = np.asarray(jdepth.depth_batch_pipeline(
        jnp.asarray(frames), params=jp, unsqueeze=unsqueeze))
    got = tdepth.depth_batch_pipeline(torch.from_numpy(frames), params=p,
                                      unsqueeze=unsqueeze)
    assert got.dtype == torch.uint16 and got.shape == want.shape
    scale = 65535.0 / 16
    a = got.to(torch.int32).numpy() / scale
    b = want.astype(np.float64) / scale
    assert_c5(a, b, a > 0, b > 0)


def _write_sbs_video(path, n_frames):
    import cv2

    frames = _sbs_frames(2, b=n_frames, h=32, w_eye=64)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             24.0, (128, 32))
    for f in frames:
        writer.write(f[..., ::-1])
    writer.release()


@pytest.mark.parametrize("clip", ["conftest", "shifted"])
def test_process_video_sbs_matches_jax(tmp_path, clip):
    """``conftest``: the repo's test clip (gradients; its eyes hold no
    stereo match, so both stages must agree that nothing is valid);
    ``shifted``: a clip whose right eye is the left shifted by 3 px."""
    from video3d_tpu.core import list_depth_frames, load_depth_png16

    video = tmp_path / "sbs.mp4"
    if clip == "conftest":
        make_test_video(video, n_frames=5, width=128, height=32)
    else:
        _write_sbs_video(video, 5)
    p = SGBMParams(num_disparities=16)
    jp = JaxParams(num_disparities=16)
    jcache = jdepth.StereoDepthExtractor(
        work_dir=str(tmp_path / "jax"), batch_size=2, guidance="none",
        params=jp).process_video_sbs(str(video))
    ext = tdepth.StereoDepthExtractor(work_dir=str(tmp_path / "torch"),
                                      batch_size=2, params=p, device="cpu",
                                      guidance="none")
    tcache = ext.process_video_sbs(str(video))
    jnames = [f.name for f in list_depth_frames(jcache)]
    tnames = [f.name for f in list_depth_frames(tcache)]
    assert tnames == jnames and len(tnames) == 5
    scale = 65535.0 / 16
    a = np.stack([load_depth_png16(f) for f in list_depth_frames(tcache)])
    b = np.stack([load_depth_png16(f) for f in list_depth_frames(jcache)])
    a, b = a / scale, b / scale
    assert_c5(a, b, a > 0, b > 0, min_valid=0.0 if clip == "conftest" else 0.3)
    assert "+torch" in ext._model_key()
    # a second run is a cache hit
    assert ext.process_video_sbs(str(video)) == tcache


def test_guidance_not_yet_ported(tmp_path):
    """Only the mono backend is left to port; CREStereo is the default."""
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tdepth.StereoDepthExtractor(work_dir=str(tmp_path),
                                    guidance="mono", device="cpu")
    ext = tdepth.StereoDepthExtractor(work_dir=str(tmp_path), device="cpu")
    assert ext.guidance == "crestereo"


def test_no_silent_cpu_fallback(tmp_path, monkeypatch):
    """Without CUDA the extractor raises unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tdepth.StereoDepthExtractor(work_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdepth.StereoDepthExtractor(work_dir=str(tmp_path), device="cuda")
    ext = tdepth.StereoDepthExtractor(work_dir=str(tmp_path), device="cpu")
    assert ext.device == torch.device("cpu")


def test_cli_stereo_only_and_unported_flags(tmp_path, capsys):
    from video3d_tpu_torch.cli.depth import main

    video = tmp_path / "sbs.mp4"
    make_test_video(video, n_frames=3, width=64, height=24)
    assert main([str(video), "--auto-range", "--stereo-only",
                 "--device", "cpu"]) == 2
    assert "not yet ported" in capsys.readouterr().err
    # no flag: the CREStereo hybrid, the JAX CLI's default
    hybrid = tmp_path / "wh"
    assert main([str(video), "--work-dir", str(hybrid), "--max-frames", "2",
                 "--batch-size", "2", "--device", "cpu"]) == 0
    assert "Guidance model loaded: crestereo" in capsys.readouterr().out
    assert sorted(f.name for f in hybrid.glob("depth_*/depth_*.png")) == [
        "depth_000000.png", "depth_000001.png"]
    work = tmp_path / "wd"
    assert main([str(video), "--stereo-only", "--work-dir", str(work),
                 "--max-frames", "2", "--batch-size", "2",
                 "--device", "cpu"]) == 0
    pngs = sorted(work.glob("depth_*/depth_*.png"))
    assert [f.name for f in pngs] == ["depth_000000.png", "depth_000001.png"]
    flow = tmp_path / "wf"
    assert main([str(video), "--temporal-smooth", "flow", "--stereo-only",
                 "--work-dir", str(flow), "--max-frames", "3",
                 "--batch-size", "2", "--device", "cpu"]) == 0
    dirs = list(flow.glob("depth_*"))
    assert len(dirs) == 1
    assert sorted(f.name for f in dirs[0].glob("depth_*.png")) == [
        f"depth_{i:06d}.png" for i in range(3)]
