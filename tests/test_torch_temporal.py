"""The port's temporal smoothers and the smoothed depth stage vs JAX.

The median-of-3 works on integers and must equal the JAX stream exactly.
The flow-EMA stream's uint16 output may differ by the rounding of f32
sums that run in another order: frame 0 equal, elsewhere |d| <= 2 uint16
units on >= 99.9% of pixels. The whole stage is held to the ROADMAP C5
tolerance (see tests/test_torch_depth.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_flow import smooth_texture
from tests.test_torch_depth import _sbs_frames, _write_sbs_video, assert_c5
from video3d_tpu.ops.stereo import SGBMParams as JaxParams
from video3d_tpu.parallel import temporal as jtemporal
from video3d_tpu.stages import depth as jdepth
from video3d_tpu_torch.ops.stereo import SGBMParams
from video3d_tpu_torch.parallel import temporal as ttemporal
from video3d_tpu_torch.stages import depth as tdepth

CHUNKS = [(0, 4), (4, 7), (7, 10), (10, 11)]  # uneven, with a 1-frame tail


def _uint16_stream(seed=3, t=11, h=6, w=10):
    return np.random.default_rng(seed).integers(
        0, 65536, (t, h, w)).astype(np.uint16)


def test_temporal_median3_local_exact():
    d = _uint16_stream()
    got = ttemporal.temporal_median3_local(torch.from_numpy(d))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jtemporal.temporal_median3_local(
            jnp.asarray(d))))


def test_temporal_median_stream_exact():
    d = _uint16_stream(seed=4)
    s_t = ttemporal.TemporalMedianStream()
    s_j = jtemporal.TemporalMedianStream()
    got, want = [], []
    for a, b in CHUNKS:
        o_t = s_t.push(torch.from_numpy(d[a:b]))
        o_j = s_j.push(jnp.asarray(d[a:b]))
        assert (o_t is None) == (o_j is None)
        if o_t is not None:
            got.append(o_t.numpy())
            want.append(np.asarray(o_j))
    got.append(s_t.flush().numpy())
    want.append(np.asarray(s_j.flush()))
    assert s_t.flush() is None
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    np.testing.assert_array_equal(
        np.concatenate(got),
        np.asarray(jtemporal.temporal_median3_local(jnp.asarray(d))))


def _flow_clip(t=15, h=64, w=96, s=4, step=4, seed=6):
    """Smooth uint16 depth and its 1/s guide, panning ``step`` px/frame
    (step/s px at the guide)."""
    rng = np.random.default_rng(seed)
    big_d = smooth_texture(rng, h, w + step * t, scale=50000.0) + 5000.0
    big_g = smooth_texture(rng, h // s, (w + step * t) // s)
    depth = np.stack([big_d[:, step * i:step * i + w] for i in range(t)])
    guide = np.stack([big_g[:, step // s * i:step // s * i + w // s]
                      for i in range(t)])
    return depth.astype(np.uint16), guide.astype(np.float32)


def _assert_close_uint16(got: np.ndarray, want: np.ndarray) -> None:
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert (d <= 2).mean() >= 0.999, \
        f"{(d <= 2).mean():.5f} within 2; max {d.max()}"


def test_flow_stream_matches_jax():
    depth, guide = _flow_clip()
    s_t = ttemporal.TemporalFlowEMAStream()
    s_j = jtemporal.TemporalFlowEMAStream()
    got, want = [], []
    for a in range(0, 15, 5):
        o = s_t.push(torch.from_numpy(depth[a:a + 5]),
                     torch.from_numpy(guide[a:a + 5]))
        assert o.dtype == torch.uint16 and o.shape == (5, 64, 96)
        got.append(o.numpy())
        want.append(np.asarray(s_j.push(jnp.asarray(depth[a:a + 5]),
                                        jnp.asarray(guide[a:a + 5]))))
    got, want = np.concatenate(got), np.concatenate(want)
    np.testing.assert_array_equal(got[0], depth[0])
    np.testing.assert_array_equal(got[0], want[0])
    _assert_close_uint16(got[1:], want[1:])
    assert s_t.flush() is None


def test_flow_stream_continues_jax_carry():
    """The JAX stream's carry after two batches, handed to the port,
    continues the stream: batch 2 agrees."""
    depth, guide = _flow_clip(seed=7)
    s_j = jtemporal.TemporalFlowEMAStream()
    for a in (0, 5):
        s_j.push(jnp.asarray(depth[a:a + 5]), jnp.asarray(guide[a:a + 5]))
    carry = tuple(np.asarray(c) for c in s_j._carry)
    s_t = ttemporal.TemporalFlowEMAStream(carry=carry)
    got = s_t.push(torch.from_numpy(depth[10:]), torch.from_numpy(guide[10:]))
    want = np.asarray(s_j.push(jnp.asarray(depth[10:]),
                               jnp.asarray(guide[10:])))
    _assert_close_uint16(got.numpy(), want)


@pytest.mark.parametrize("scale", [4, 2])
def test_return_guide_matches_jax(scale):
    frames = _sbs_frames(5, b=2, h=32, w_eye=64)
    depth, guide = tdepth.depth_batch_pipeline(
        torch.from_numpy(frames), params=SGBMParams(num_disparities=16),
        return_guide=True, guide_scale=scale)
    _, want = jdepth.depth_batch_pipeline(
        jnp.asarray(frames), params=JaxParams(num_disparities=16),
        return_guide=True, guide_scale=scale)
    assert guide.shape == want.shape == (2, 32 // scale, 128 // scale)
    assert guide.dtype == torch.float32
    np.testing.assert_allclose(guide.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("smooth,flow_scale", [("flow", 4), ("flow", 2),
                                               ("median", 4)])
def test_smoothed_stage_matches_jax(tmp_path, smooth, flow_scale):
    from video3d_tpu.core import list_depth_frames, load_depth_png16

    video = tmp_path / "sbs.mp4"
    _write_sbs_video(video, 5)
    p = SGBMParams(num_disparities=16)
    jp = JaxParams(num_disparities=16)
    jcache = jdepth.StereoDepthExtractor(
        work_dir=str(tmp_path / "jax"), batch_size=2, guidance="none",
        params=jp, temporal_smooth=smooth,
        flow_scale=flow_scale).process_video_sbs(str(video))
    ext = tdepth.StereoDepthExtractor(
        work_dir=str(tmp_path / "torch"), batch_size=2, params=p,
        temporal_smooth=smooth, flow_scale=flow_scale, device="cpu",
        guidance="none")
    tcache = ext.process_video_sbs(str(video))
    jnames = [f.name for f in list_depth_frames(jcache)]
    tnames = [f.name for f in list_depth_frames(tcache)]
    assert tnames == jnames and len(tnames) == 5
    key = ext._model_key()
    tag = {"flow": "+tflow" if flow_scale == 4 else "+tflow@2",
           "median": "+tmedian"}[smooth]
    assert tag in key and key.endswith("+torch")
    scale = 65535.0 / 16
    a = np.stack([load_depth_png16(f) for f in list_depth_frames(tcache)])
    b = np.stack([load_depth_png16(f) for f in list_depth_frames(jcache)])
    a, b = a / scale, b / scale
    assert_c5(a, b, a > 0, b > 0)


def test_smoother_options_validated(tmp_path):
    with pytest.raises(ValueError, match="temporal_smooth"):
        tdepth.StereoDepthExtractor(work_dir=str(tmp_path),
                                    temporal_smooth="blur", device="cpu")
    with pytest.raises(ValueError, match="flow_scale"):
        tdepth.StereoDepthExtractor(work_dir=str(tmp_path), flow_scale=3,
                                    device="cpu")
    ext = tdepth.StereoDepthExtractor(work_dir=str(tmp_path),
                                      temporal_median=True, device="cpu")
    assert ext.temporal_smooth == "median"
    assert "+tmedian" in ext._model_key()
    plain = tdepth.StereoDepthExtractor(work_dir=str(tmp_path), device="cpu",
                                        guidance="none")
    assert "+t" not in plain._model_key().replace("+torch", "")
