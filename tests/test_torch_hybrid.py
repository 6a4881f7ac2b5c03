"""The port's DPT hybrid depth path vs the JAX package.

Same numpy inputs (fixed seeds) go to both. Tolerances:

* ``ssi_align`` and ``confidence_trust_blend`` (trust_scale 1, 2, 4):
  rtol 1e-5 plus atol 1e-5 on the disparity scale (sums in another
  order).
* The guidance branch (keyframe cadence, min-max, SSI, blend) against the
  same steps composed from the JAX functions: rtol 1e-5, atol 1e-4 px.
* The whole stage with tiny DPT guidance against a JAX reference composed
  of the TPU-path matcher in interpret mode, JAX ``fill_holes``, the JAX
  DPT guidance and the JAX blend: f32 sums in another order move a few
  values across a uint16 truncation step, so the maps agree exactly on
  >= 99% of pixels and within 2 units (1/2048 px at D=16) on all.
* The whole stage against the JAX ``depth_batch_pipeline``, whose matcher
  on the CPU is the f32 XLA path: the ROADMAP C5 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_depth import _sbs_frames, _write_sbs_video, assert_c5
from tests.test_torch_stereo import _jax_tpu_path
from video3d_tpu.models import dpt as jdpt
from video3d_tpu.models.mono import ssi_align as jax_ssi_align
from video3d_tpu.ops import image as jimage
from video3d_tpu.ops.fill import fill_holes as jax_fill
from video3d_tpu.ops.stereo import SGBMParams as JaxParams
from video3d_tpu.stages import depth as jdepth
from video3d_tpu_torch.models import dpt as tdpt
from video3d_tpu_torch.models.mono import ssi_align
from video3d_tpu_torch.ops.stereo import SGBMParams
from video3d_tpu_torch.stages import depth as tdepth

D = 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _blend_inputs(seed, b=2, h=40, w=72):
    """disp with invalid (-1) pixels, a confidence in [0, 1] (frame 1 with
    under 32 of confident mass), and a guide near the disparity."""
    r = np.random.default_rng(seed)
    disp = r.uniform(0, D, (b, h, w)).astype(np.float32)
    disp[r.random(disp.shape) < 0.2] = -1.0
    margin = r.uniform(0, 1, (b, h, w)).astype(np.float32)
    margin[1] *= 0.005
    guide = (np.clip(disp, 0, None)
             + r.normal(0, 2.0, disp.shape)).astype(np.float32)
    return disp, margin, guide


def test_ssi_align_matches_jax():
    r = np.random.default_rng(1)
    pred = r.uniform(0, 1, (3, 20, 30)).astype(np.float32)
    target = (3.0 * pred + 2.0 + r.normal(0, 0.1, pred.shape)).astype(
        np.float32)
    w = r.uniform(0, 1, pred.shape).astype(np.float32)
    pred[2] = 0.25  # flat: degenerate fit, s = 1
    w[1] = 0.0  # no support
    s, t = ssi_align(_t(pred), _t(target), _t(w))
    js, jt = jax_ssi_align(jnp.asarray(pred), jnp.asarray(target),
                           jnp.asarray(w))
    assert s.shape == t.shape == (3, 1, 1)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-5)
    assert abs(s[0].item() - 3.0) < 0.05 and s[2].item() == 1.0


@pytest.mark.parametrize("trust_scale", [1, 2, 4])
def test_confidence_trust_blend_matches_jax(trust_scale):
    disp, margin, guide = _blend_inputs(2)
    want = np.asarray(jdepth.confidence_trust_blend(
        jnp.asarray(disp), jnp.asarray(margin), jnp.asarray(guide),
        min_disparity=0.0, trust_scale=trust_scale))
    got = tdepth.confidence_trust_blend(_t(disp), _t(margin), _t(guide),
                                        min_disparity=0.0,
                                        trust_scale=trust_scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The guidance branch
# ---------------------------------------------------------------------------


def _jax_guidance_branch(disp, margin, left, right, fn, p, kev,
                         stereo_weight=0.7, blend="confidence",
                         trust_scale=1):
    """The guidance branch of the JAX ``depth_batch_pipeline``
    (stages/depth.py:225-291), composed from the JAX functions."""
    b = left.shape[0]
    eyes = (left, right) if fn.stereo else (left,)
    out = fn(*(e[::kev] for e in eyes) if kev > 1 else eyes)
    if kev > 1:
        out = jnp.repeat(out, kev, axis=0)[:b]
    if fn.stereo:  # disparity already: blended as it is
        guide = out
        if blend == "confidence":
            return jdepth.confidence_trust_blend(
                disp, margin, guide, min_disparity=float(p.min_disparity),
                trust_scale=trust_scale)
        return stereo_weight * disp + (1.0 - stereo_weight) * guide
    mono = out
    mmin = jnp.min(mono, axis=(-2, -1), keepdims=True)
    mmax = jnp.max(mono, axis=(-2, -1), keepdims=True)
    guide = (mono - mmin) / jnp.maximum(mmax - mmin, 1e-6) * float(
        p.num_disparities)
    if blend == "confidence":
        conf_w = jnp.where(disp > float(p.min_disparity) - 0.5, margin, 0.0)
        s, t = jax_ssi_align(mono, jnp.maximum(disp, 0.0), conf_w)
        g_ssi = jnp.clip(mono * s + t, 0.0, float(p.num_disparities))
        guide = jnp.where(s > 0.0, g_ssi, guide)
        return jdepth.confidence_trust_blend(
            disp, margin, guide, min_disparity=float(p.min_disparity),
            trust_scale=trust_scale)
    return stereo_weight * disp + (1.0 - stereo_weight) * guide


class _Recorder:
    """A guidance fn (in both frameworks) that records batch sizes: mono
    relative depth from the left eye, or with ``stereo`` a disparity in
    [0, 16) from both."""

    def __init__(self, stereo=False):
        self.stereo, self.sizes = stereo, []

    def __call__(self, left, right=None):
        self.sizes.append(left.shape[0])
        mono = (left[..., 0] * 0.5 + left[..., 1] * 0.3
                + left[..., 2] * 0.2) ** 1.5
        if self.stereo:
            return (left - right).mean(-1) % 16.0
        return mono


@pytest.mark.parametrize("kev,b,blend,stereo", [
    (1, 4, "confidence", False), (4, 8, "confidence", False),
    (4, 6, "confidence", False), (4, 6, "fixed", False),
    (1, 3, "fixed", False), (4, 6, "confidence", True)])
def test_guidance_branch_matches_jax(kev, b, blend, stereo):
    r = np.random.default_rng(3)
    disp, margin, _ = _blend_inputs(4, b=b, h=24, w=40)
    left = r.uniform(0, 255, (b, 24, 40, 3)).astype(np.float32)
    right = r.uniform(0, 255, (b, 24, 40, 3)).astype(np.float32)
    p = SGBMParams(num_disparities=D)
    jfn, tfn = _Recorder(stereo), _Recorder(stereo)
    want = np.asarray(_jax_guidance_branch(
        jnp.asarray(disp), jnp.asarray(margin), jnp.asarray(left),
        jnp.asarray(right), jfn, JaxParams(num_disparities=D), kev,
        blend=blend))
    got = tdepth.guidance_blend(_t(disp), _t(margin), _t(left), _t(right),
                                tfn, p, guidance_every=kev, blend=blend)
    assert tfn.sizes == jfn.sizes == [-(-b // kev)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# The whole hybrid stage with tiny DPT guidance
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_dpt():
    """(JAX guidance fn, port guidance fn) on the same random tiny DPT
    weights, f32, at the tiny model's 64 px inference size."""
    cfg = jdpt.DPTConfig.tiny()
    model = jdpt.DPTDepthModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(7),
                                 jnp.zeros((1, 64, 64, 3)))
    params = jax.tree.map(np.asarray, params)
    tmodel = tdpt.DPTDepthModel(tdpt.DPTConfig.tiny())
    tmodel.load_state_dict(tdpt.jax_params_to_state_dict(
        params, tdpt.DPTConfig.tiny()))
    jfn = jdpt.make_guidance_fn(model, params, infer_size=64)
    return jfn, tdpt.make_guidance_fn(tmodel, infer_size=64)


def _jax_hybrid_reference(frames, jfn, kev):
    """uint16 maps of the JAX hybrid stage on its TPU path (matcher in
    interpret mode), composed step by step."""
    jp = JaxParams(num_disparities=D)
    left, right = jimage.split_sbs(jnp.asarray(frames))
    left, right = (jnp.moveaxis(jimage.unsqueeze_width(
        jnp.moveaxis(e.astype(jnp.float32), -1, 1)), 1, -1)
        for e in (left, right))
    disp, conf = _jax_tpu_path(np.asarray(jimage.rgb_to_gray(left)),
                               np.asarray(jimage.rgb_to_gray(right)), jp,
                               True)
    disp = jax_fill(jnp.asarray(disp), float(jp.min_disparity - 1))
    disp = _jax_guidance_branch(disp, jnp.asarray(conf), left, right,
                                jax.jit(jfn), jp, kev)
    scaled = jnp.maximum(disp, 0.0) * (65535.0 / D)
    return np.asarray(jnp.clip(scaled, 0.0, 65535.0).astype(jnp.uint16))


def test_hybrid_stage_matches_composed_jax_reference(tiny_dpt):
    jfn, tfn = tiny_dpt
    frames = _sbs_frames(5, b=3)
    want = _jax_hybrid_reference(frames, jfn, kev=2)
    got = tdepth.depth_batch_pipeline(
        _t(frames), params=SGBMParams(num_disparities=D), guidance_fn=tfn,
        guidance_every=2, fill_holes=True)
    assert got.dtype == torch.uint16 and got.shape == want.shape
    d = np.abs(got.to(torch.int32).numpy() - want.astype(np.int32))
    assert d.max() <= 2 and (d == 0).mean() >= 0.99, (d.max(), (d == 0).mean())


def test_hybrid_stage_matches_jax_pipeline_c5(tiny_dpt):
    jfn, tfn = tiny_dpt
    frames = _sbs_frames(6, b=6)
    want = np.asarray(jdepth.depth_batch_pipeline(
        jnp.asarray(frames), params=JaxParams(num_disparities=D),
        guidance_fn=jfn, guidance_params=jfn.params, guidance_every=4,
        fill_holes=True))
    got = tdepth.depth_batch_pipeline(
        _t(frames), params=SGBMParams(num_disparities=D), guidance_fn=tfn,
        guidance_every=4, fill_holes=True)
    scale = 65535.0 / D
    a = got.to(torch.int32).numpy() / scale
    b = want.astype(np.float64) / scale
    assert_c5(a, b, a > 0, b > 0)


# ---------------------------------------------------------------------------
# The extractor, its cache key and the CLI
# ---------------------------------------------------------------------------


def test_extractor_dpt_on_a_clip_matches_jax(tmp_path, tiny_dpt):
    from video3d_tpu.core import list_depth_frames, load_depth_png16

    jfn, tfn = tiny_dpt
    video = tmp_path / "sbs.mp4"
    _write_sbs_video(video, 5)
    jext = jdepth.StereoDepthExtractor(
        work_dir=str(tmp_path / "jax"), batch_size=4, guidance="dpt",
        params=JaxParams(num_disparities=D))
    jext._guidance_fn, jext._guidance_loaded = jfn, True
    ext = tdepth.StereoDepthExtractor(
        work_dir=str(tmp_path / "torch"), batch_size=4, guidance="dpt",
        params=SGBMParams(num_disparities=D), device="cpu")
    ext._guidance_fn, ext._guidance_loaded = tfn, True
    jcache = jext.process_video_sbs(str(video))
    tcache = ext.process_video_sbs(str(video))
    assert ext._model_key() == jext._model_key() + "+torch"
    assert "+blend=conf+fill+gev4" in ext._model_key()
    scale = 65535.0 / D
    a = np.stack([load_depth_png16(f) for f in list_depth_frames(tcache)])
    b = np.stack([load_depth_png16(f) for f in list_depth_frames(jcache)])
    assert a.shape == b.shape == (5, 32, 128)
    assert_c5(a / scale, b / scale, a > 0, b > 0)


def test_failed_guidance_load_keys_as_stereo_only(tmp_path, capsys):
    """ROADMAP C2, repaired in the port: a DPT load that falls back writes
    under the stereo-only key, without +fill."""
    video = tmp_path / "sbs.mp4"
    _write_sbs_video(video, 2)
    kw = dict(work_dir=str(tmp_path / "wd"), batch_size=2,
              params=SGBMParams(num_disparities=D), device="cpu")
    ext = tdepth.StereoDepthExtractor(
        guidance="dpt", model_checkpoint=str(tmp_path / "missing"), **kw)
    assert "+fill" in ext._model_key()  # before the load resolves
    cache = ext.process_video_sbs(str(video))
    assert "guidance load failed" in capsys.readouterr().out
    assert ext.guidance == "none" and not ext.fill_holes
    key = ext._model_key()
    assert "+fill" not in key and "+blend" not in key and "+gev" not in key
    plain = tdepth.StereoDepthExtractor(guidance="none", **kw)
    assert key == plain._model_key()
    assert plain.process_video_sbs(str(video)) == cache  # a cache hit


@pytest.mark.parametrize("opts", [
    dict(guidance="dpt"),
    dict(guidance="dpt", blend="fixed", stereo_weight=0.5,
         guidance_every=1),
    dict(guidance="dpt", fill_holes=False, trust_scale=2),
    dict(guidance="none", fill_holes=True),
    dict(guidance="none", stereo_weight=0.6),
])
def test_cache_key_tags_match_jax(tmp_path, opts):
    ext = tdepth.StereoDepthExtractor(work_dir=str(tmp_path), device="cpu",
                                      **opts)
    jext = jdepth.StereoDepthExtractor(work_dir=str(tmp_path), **opts)
    # the port tags the trust scale, which the JAX key leaves out
    ts = "+ts2" if opts.get("trust_scale") == 2 else ""
    assert ext._model_key() == jext._model_key() + ts + "+torch"


def test_cache_key_tags_trust_scale(tmp_path):
    """Two extractors that differ only in ``trust_scale`` write different
    maps, so they get different keys; without the confidence blend the
    scale changes nothing and the key stays."""
    kw = dict(work_dir=str(tmp_path), device="cpu", guidance="dpt")
    keys = [tdepth.StereoDepthExtractor(trust_scale=s, **kw)._model_key()
            for s in (1, 2, 4)]
    assert len(set(keys)) == 3 and "+ts" not in keys[0]
    assert keys[1].endswith("+ts2+torch") and keys[2].endswith("+ts4+torch")
    fixed = [tdepth.StereoDepthExtractor(trust_scale=s, blend="fixed",
                                         **kw)._model_key() for s in (1, 2)]
    assert fixed[0] == fixed[1]


def test_unported_guidance_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tdepth.StereoDepthExtractor(work_dir=str(tmp_path), guidance="mono",
                                    device="cpu")


def test_cli_guidance_dpt(tmp_path, capsys):
    transformers = pytest.importorskip("transformers")
    from tests.test_torch_dpt import _hf_tiny
    from video3d_tpu_torch.cli.depth import main

    assert transformers is not None
    ckpt = tmp_path / "dpt"
    _hf_tiny(seed=1).save_pretrained(ckpt, safe_serialization=True)
    video = tmp_path / "sbs.mp4"
    _write_sbs_video(video, 3)
    work = tmp_path / "wd"
    assert main([str(video), "--guidance", "dpt", "--model", str(ckpt),
                 "--work-dir", str(work), "--max-frames", "3",
                 "--batch-size", "2", "--device", "cpu"]) == 0
    assert "Guidance model loaded: dpt" in capsys.readouterr().out
    pngs = sorted(work.glob("depth_*/depth_*.png"))
    assert [f.name for f in pngs] == [f"depth_{i:06d}.png" for i in range(3)]
    assert main([str(video), "--guidance", "mono", "--device", "cpu"]) == 2
    assert "not yet ported" in capsys.readouterr().err
