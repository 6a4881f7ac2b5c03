"""The port's CREStereo-lite guidance vs the JAX package's.

Same numpy inputs (fixed seeds) go to both; the bundled weights are the
JAX package's ``crestereo_ckpt/``, restored with orbax. Tolerances:

* ``build_corr_volume`` and ``lookup_corr``: exact. The features are
  small integers, so every product and partial sum is exact in f32 (and
  the bf16 sums round one exact value), whatever the summation order; the
  lookup selects and interpolates the same values.
* ``CREStereoLite`` in f32 on the bundled weights at 64x256: within 1e-3
  px everywhere (convolutions summed in another order).
* In bf16: the convs round to bf16 at other points than XLA's fused
  elementwise chains, and six GRU steps carry that on, so the bound is a
  share: >= 99.5% of pixels within 0.25 px, median |d| <= 0.05 px.
* The guidance fn's HD branch (720x256, half-resolution inference) in f32:
  within 1e-3 px.
* The stage with CREStereo guidance against the JAX pipeline and the
  extractor on a clip: ROADMAP C5 (``tests/test_torch_depth.py
  assert_c5``).
"""

import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_depth import _sbs_frames, _write_sbs_video, assert_c5
from video3d_tpu.models import crestereo as jcre
from video3d_tpu.ops.stereo import SGBMParams as JaxParams
from video3d_tpu.stages import depth as jdepth
from video3d_tpu_torch.models import crestereo as tcre
from video3d_tpu_torch.ops.stereo import SGBMParams
from video3d_tpu_torch.stages import depth as tdepth

REPO = Path(__file__).resolve().parents[1]
CKPT = str(REPO / "crestereo_ckpt")
D = 16


@pytest.fixture(scope="module")
def jax_params():
    return jcre.load_checkpoint(os.path.abspath(CKPT))


def _pair(seed, b=2, h=64, w=256, shift=8, grain=2):
    """Left and right RGB eyes (B, H, W, 3) f32 in [0, 255], the right the
    left shifted by ``shift`` px (a random texture of ``grain``-px
    squares)."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 256, (b, -(-h // grain), (w + shift) // grain + 1,
                               3))
    base = np.repeat(np.repeat(base, grain, 1), grain, 2).astype(np.float32)
    return (np.ascontiguousarray(base[:, :h, :w]),
            np.ascontiguousarray(base[:, :h, shift:shift + w]))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_corr_volume_matches_jax(dtype):
    r = np.random.default_rng(0)
    fl = r.integers(-4, 5, (2, 5, 24, 16)).astype(np.float32)  # NHWC
    fr = r.integers(-4, 5, (2, 5, 24, 16)).astype(np.float32)
    want = np.asarray(jcre.build_corr_volume(
        jnp.asarray(fl, dtype), jnp.asarray(fr, dtype), 6))
    got = tcre.build_corr_volume(
        _t(fl).permute(0, 3, 1, 2).to(getattr(torch, dtype)),
        _t(fr).permute(0, 3, 1, 2).to(getattr(torch, dtype)), 6)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_lookup_corr_matches_jax():
    r = np.random.default_rng(1)
    corr = r.standard_normal((2, 6, 10, 7)).astype(np.float32)
    # in range, out of range both ways, and exact integers
    disp = r.uniform(-3.0, 10.0, (2, 6, 10)).astype(np.float32)
    disp[0, 0] = np.arange(10) - 1.0
    for radius in (2, 4):
        want = np.asarray(jcre.lookup_corr(jnp.asarray(corr),
                                           jnp.asarray(disp), radius))
        got = tcre.lookup_corr(_t(corr), _t(disp), radius)
        np.testing.assert_array_equal(got.numpy(), want)


def _port_model(dtype=torch.float32, cfg=tcre.CREStereoConfig(), sd=None):
    model = tcre.CREStereoLite(dataclasses.replace(cfg, dtype=dtype))
    model.load_state_dict(sd if sd is not None
                          else tcre.load_weights(tcre.BUNDLED_WEIGHTS))
    return model.eval()


def test_crestereo_f32_matches_flax(jax_params):
    left, right = _pair(2)
    want = np.asarray(jax.jit(jcre.CREStereoLite(jcre.CREStereoConfig()).apply)(
        jax_params, jnp.asarray(left), jnp.asarray(right)))
    with torch.no_grad():
        got = _port_model()(_t(left), _t(right)).numpy()
    assert got.shape == want.shape == (2, 64, 256)
    assert abs(np.median(want) - 8.0) < 0.5  # the pair's shift
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_crestereo_bf16_matches_flax(jax_params):
    left, right = _pair(3)
    jm = jcre.CREStereoLite(dataclasses.replace(jcre.CREStereoConfig(),
                                                dtype=jnp.bfloat16))
    want = np.asarray(jax.jit(jm.apply)(jax_params, jnp.asarray(left),
                                        jnp.asarray(right)))
    with torch.no_grad():
        got = _port_model(torch.bfloat16)(_t(left), _t(right))
    assert got.dtype == torch.float32
    d = np.abs(got.numpy() - want)
    assert (d <= 0.25).mean() >= 0.995, (d <= 0.25).mean()
    assert np.median(d) <= 0.05, np.median(d)


@pytest.mark.parametrize("max_disparity,levels", [(16, 2), (12, 3)])
def test_tiny_crestereo_matches_flax(max_disparity, levels):
    """The tiny configuration on flax's random init; max_disparity 12 gives
    3 quarter-resolution bins, so the pyramid pads an odd level twice."""
    jcfg = dataclasses.replace(jcre.CREStereoConfig.tiny(),
                               max_disparity=max_disparity,
                               corr_levels=levels)
    tcfg = dataclasses.replace(tcre.CREStereoConfig.tiny(),
                               max_disparity=max_disparity,
                               corr_levels=levels)
    left, right = _pair(4, h=32, w=64, shift=4)
    jm = jcre.CREStereoLite(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(left),
                              jnp.asarray(right))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(left),
                                        jnp.asarray(right)))
    sd = tcre.jax_params_to_state_dict(jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = _port_model(cfg=tcfg, sd=sd)(_t(left), _t(right)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_hd_guidance_matches_jax():
    """H >= 720: half-resolution inference, x2, resized back (f32)."""
    left, right = _pair(5, b=1, h=720, w=256, shift=12, grain=8)
    jfn = jcre.load_crestereo_guidance(os.path.abspath(CKPT),
                                       dtype=jnp.float32)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(left), jnp.asarray(right)))
    tfn = tcre.load_crestereo_guidance(dtype=torch.float32, device="cpu")
    assert tfn.stereo
    got = tfn(_t(left), _t(right)).numpy()
    assert got.shape == want.shape == (1, 720, 256)
    assert abs(np.median(want) - 12.0) < 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_bundled_weights_pinned_to_checkpoint(jax_params):
    """The committed safetensors file equals the orbax checkpoint, bit for
    bit, through :func:`jax_params_to_state_dict`."""
    want = tcre.jax_params_to_state_dict(jax_params)
    got = tcre.load_weights(tcre.BUNDLED_WEIGHTS)
    assert sorted(got) == sorted(want) and len(got) == 26
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    assert sum(t.numel() for t in got.values()) == 552161
    assert _port_model().state_dict().keys() == got.keys()


def test_conv_flops_counts_the_convs():
    """:func:`conv_flops` against the convs a forward runs, counted by
    hooks from their outputs."""
    model = tcre.CREStereoLite()
    total = [0]

    def hook(mod, args, out):
        k = mod.weight[0].numel()  # cin * kh * kw
        total[0] += 2 * out.numel() * k
    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_hook(hook)
    left, right = _pair(6, b=1, h=54, w=96)
    with torch.no_grad():
        model(_t(left), _t(right))
    assert tcre.conv_flops(model.cfg, 54, 96) == total[0]


def test_loader_defaults_to_cuda(monkeypatch):
    with pytest.raises(FileNotFoundError):
        tcre.load_crestereo_guidance("missing.safetensors", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcre.load_crestereo_guidance()


# ---------------------------------------------------------------------------
# The stage, the extractor and the CLI
# ---------------------------------------------------------------------------


def test_hybrid_stage_crestereo_matches_jax_pipeline_c5():
    frames = _sbs_frames(7, b=4)
    jfn = jcre.load_crestereo_guidance(os.path.abspath(CKPT))
    want = np.asarray(jdepth.depth_batch_pipeline(
        jnp.asarray(frames), params=JaxParams(num_disparities=D),
        guidance_fn=jfn, guidance_params=jfn.params, guidance_every=4,
        fill_holes=True))
    tfn = tcre.load_crestereo_guidance(device="cpu")
    got = tdepth.depth_batch_pipeline(
        _t(frames), params=SGBMParams(num_disparities=D), guidance_fn=tfn,
        guidance_every=4, fill_holes=True)
    scale = 65535.0 / D
    a = got.to(torch.int32).numpy() / scale
    b = want.astype(np.float64) / scale
    assert_c5(a, b, a > 0, b > 0)


def test_extractor_default_is_crestereo_and_matches_jax(tmp_path, capsys):
    from video3d_tpu_torch.core import list_depth_frames, load_depth_png16

    video = tmp_path / "sbs.mp4"
    _write_sbs_video(video, 5)
    jext = jdepth.StereoDepthExtractor(
        work_dir=str(tmp_path / "jax"), batch_size=4, guidance="crestereo",
        params=JaxParams(num_disparities=D))
    ext = tdepth.StereoDepthExtractor(
        work_dir=str(tmp_path / "torch"), batch_size=4,
        params=SGBMParams(num_disparities=D), device="cpu")
    assert ext.guidance == "crestereo" and ext.fill_holes
    assert ext.model_checkpoint == str(tcre.BUNDLED_WEIGHTS)
    jcache = jext.process_video_sbs(str(video))
    tcache = ext.process_video_sbs(str(video))
    assert "Guidance model loaded: crestereo" in capsys.readouterr().out
    assert ext.guidance == "crestereo"  # no degrade to stereo-only
    key = ext._model_key()
    assert key.startswith(str(tcre.BUNDLED_WEIGHTS) + "+a2")
    assert key.endswith("+blend=conf+fill+gev4+sgbm(num_disparities=16)"
                        "+torch")
    assert key.replace(str(tcre.BUNDLED_WEIGHTS), "") == \
        jext._model_key().replace(jext.model_checkpoint, "") + "+torch"
    scale = 65535.0 / D
    a = np.stack([load_depth_png16(f) for f in list_depth_frames(tcache)])
    b = np.stack([load_depth_png16(f) for f in list_depth_frames(jcache)])
    assert a.shape == b.shape == (5, 32, 128)
    assert_c5(a / scale, b / scale, a > 0, b > 0)


def test_missing_weights_degrade_to_stereo_only(tmp_path, capsys):
    """The reference's soft fallback: a CREStereo load that fails runs and
    keys stereo-only (the smoke fails on it)."""
    video = tmp_path / "sbs.mp4"
    _write_sbs_video(video, 2)
    ext = tdepth.StereoDepthExtractor(
        work_dir=str(tmp_path), batch_size=2, device="cpu",
        model_checkpoint=str(tmp_path / "missing.safetensors"),
        params=SGBMParams(num_disparities=D))
    ext.process_video_sbs(str(video))
    assert "guidance load failed" in capsys.readouterr().out
    assert ext.guidance == "none" and not ext.fill_holes
    plain = tdepth.StereoDepthExtractor(
        work_dir=str(tmp_path), guidance="none", device="cpu",
        params=SGBMParams(num_disparities=D))
    assert ext._model_key() == plain._model_key()


def test_cli_default_runs_the_crestereo_hybrid(tmp_path, capsys):
    from tests.conftest import make_test_video
    from video3d_tpu_torch.cli.depth import main

    video = tmp_path / "sbs.mp4"
    make_test_video(video, n_frames=3, width=256, height=64)
    work = tmp_path / "wd"
    assert main([str(video), "--work-dir", str(work), "--max-frames", "3",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Guidance model loaded: crestereo" in out
    assert "guidance=crestereo" in out
    pngs = sorted(work.glob("depth_*/depth_*.png"))
    assert [f.name for f in pngs] == [f"depth_{i:06d}.png" for i in range(3)]
