"""The port's guided upscale ops, upscale stage and CLI vs the JAX package.

Same numpy inputs (fixed seeds) go to both, at 24x40 -> 48x80 (radius 8
and 2). Tolerances, in uint16 units of the output (1/65535 of the depth
range):

* ``_quantize`` and ``plain_upsample``: exact (the same f32 resize
  matrices, one product and the same rounding).
* ``guided_upsample`` (gray with an RGB or a luma guide, color),
  ``adaptive_upsample`` and ``guided_filter``: the box filters are
  cumulative sums, in f32 in the JAX package and in f64 in the port, and
  the variances subtract two of them, so the JAX sums' rounding reaches
  ``a`` magnified by 1/(var + eps); the color mode divides by a 3x3
  determinant of them. On these per-pixel noisy guides that moves the
  output by up to 1.6 units (radius 2, color). So every output is held
  within 2 units, >= 99% of pixels within 1, and >= 90% of quantized
  pixels equal.
* ``DepthUpscaler`` with ``png16_out`` on a synthetic clip against the JAX
  stage: the op's tolerance on every frame.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video3d_tpu.ops import guided as jg
from video3d_tpu.stages import upscale as jup
from video3d_tpu_torch.core import (list_depth_frames, load_depth_png16,
                                    save_depth_png16)
from video3d_tpu_torch.ops import guided as tg
from video3d_tpu_torch.stages import upscale as tup

B, H_LO, W_LO, H_HI, W_HI = 2, 24, 40, 48, 80


def _inputs(seed):
    """uint16 depth with an edge, a ramp and noise; an RGB guide whose
    edge sits where the depth's does; a luma plane."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H_LO, :W_LO]
    depth = ((xx > W_LO // 2) * 40000 + yy * 300
             + r.integers(0, 2000, (B, H_LO, W_LO))).astype(np.uint16)
    guide = r.integers(0, 120, (B, H_HI, W_HI, 3))
    guide[:, :, W_HI // 2:] += 100
    luma = r.integers(0, 256, (B, H_HI, W_HI))
    return depth, guide.astype(np.uint8), luma.astype(np.uint8)


def _cmp(got: torch.Tensor, want, out_dtype: str) -> None:
    a = got.to(torch.float64 if out_dtype == "float32"
               else torch.int32).numpy().astype(np.float64)
    b = np.asarray(want).astype(np.float64)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max() <= 2.0, d.max()
    assert (d <= 1.0).mean() >= 0.99, (d <= 1.0).mean()
    if out_dtype != "float32":
        assert (d == 0).mean() >= 0.90, (d == 0).mean()
        assert str(got.dtype) == f"torch.{out_dtype}"


@pytest.mark.parametrize("out_dtype", ["uint16", "uint8"])
def test_quantize_matches_jax(out_dtype):
    q = np.concatenate([
        np.array([-0.1, 0.0, 0.5 / 65535, 1.5 / 65535, 0.5, 1.0, 1.2],
                 np.float32),
        np.random.default_rng(0).uniform(0, 1, 1000).astype(np.float32)])
    want = np.asarray(jg._quantize(jnp.asarray(q), out_dtype))
    got = tg._quantize(torch.from_numpy(q), out_dtype)
    assert str(got.dtype) == f"torch.{out_dtype}"
    np.testing.assert_array_equal(got.to(torch.int32).numpy(),
                                  want.astype(np.int32))


@pytest.mark.parametrize("radius", [8, 2])
@pytest.mark.parametrize("mode", ["gray_rgb", "gray_luma", "color"])
@pytest.mark.parametrize("out_dtype", ["float32", "uint16", "uint8"])
def test_guided_upsample_matches_jax(mode, radius, out_dtype):
    depth, guide, luma = _inputs(1)
    g = luma if mode == "gray_luma" else guide
    gm = "color" if mode == "color" else "gray"
    want = jg.guided_upsample(jnp.asarray(depth), jnp.asarray(g), H_HI, W_HI,
                              radius=radius, guide_mode=gm,
                              out_dtype=out_dtype)
    got = tg.guided_upsample(torch.from_numpy(depth), torch.from_numpy(g),
                             H_HI, W_HI, radius=radius, guide_mode=gm,
                             out_dtype=out_dtype)
    _cmp(got, want, out_dtype)


@pytest.mark.parametrize("out_dtype", ["float32", "uint16", "uint8"])
def test_plain_upsample_matches_jax(out_dtype):
    depth, _, _ = _inputs(2)
    want = np.asarray(jg.plain_upsample(jnp.asarray(depth), H_HI, W_HI,
                                        out_dtype=out_dtype))
    got = tg.plain_upsample(torch.from_numpy(depth), H_HI, W_HI,
                            out_dtype=out_dtype)
    np.testing.assert_array_equal(
        got.to(torch.float32 if out_dtype == "float32"
               else torch.int32).numpy(),
        want.astype(np.float32 if out_dtype == "float32" else np.int32))


@pytest.mark.parametrize("radius", [8, 2])
@pytest.mark.parametrize("out_dtype", ["float32", "uint16", "uint8"])
def test_adaptive_upsample_matches_jax(radius, out_dtype):
    depth, guide, _ = _inputs(3)
    want = jg.adaptive_upsample(jnp.asarray(depth), jnp.asarray(guide),
                                H_HI, W_HI, radius=radius,
                                out_dtype=out_dtype)
    got = tg.adaptive_upsample(torch.from_numpy(depth),
                               torch.from_numpy(guide), H_HI, W_HI,
                               radius=radius, out_dtype=out_dtype)
    _cmp(got, want, out_dtype)


def test_guided_filter_and_box_filter_match_jax():
    r = np.random.default_rng(4)
    guide = r.uniform(0, 1, (2, 30, 50)).astype(np.float32)
    src = r.uniform(0, 1, (2, 30, 50)).astype(np.float32)
    for radius in (8, 2):
        np.testing.assert_allclose(
            tg.box_filter(torch.from_numpy(src), radius).numpy(),
            np.asarray(jg.box_filter(jnp.asarray(src), radius)),
            rtol=1e-5, atol=1e-6)
        # in [0, 1] units: 1.0 uint16 unit
        np.testing.assert_allclose(
            tg.guided_filter(torch.from_numpy(guide), torch.from_numpy(src),
                             radius).numpy(),
            np.asarray(jg.guided_filter(jnp.asarray(guide),
                                        jnp.asarray(src), radius)),
            rtol=0, atol=1.0 / 65535)


# ---------------------------------------------------------------------------
# The stage and the CLI
# ---------------------------------------------------------------------------


def _clip(tmp_path, n_depth=5, n_video=5):
    """``n_depth`` PNG16 maps at 24x40 and an ``n_video``-frame RGB clip
    at 48x80 (the "4K" geometry of the test) whose edge matches the
    maps'."""
    import cv2

    depth_dir = tmp_path / "depth_clip"
    depth_dir.mkdir()
    for i in range(n_depth):
        save_depth_png16(depth_dir / f"depth_{i:06d}.png", _inputs(10 + i)[0][0])
    video = tmp_path / "guide.mp4"
    w = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), 24.0,
                        (W_HI, H_HI))
    for i in range(n_video):
        w.write(np.ascontiguousarray(_inputs(20 + i)[1][0][..., ::-1]))
    w.release()
    return depth_dir, video


@pytest.mark.parametrize("method,guide_mode,n_video", [
    ("adaptive", "gray", 5),
    ("guided", "gray", 5),
    ("guided", "color", 5),
    ("scale", "gray", 5),
    ("adaptive", "gray", 3),  # the guide runs dry: plain for the tail
])
def test_upscaler_png16_matches_jax(tmp_path, method, guide_mode, n_video):
    depth_dir, video = _clip(tmp_path, n_video=n_video)
    kw = dict(method=method, guide_mode=guide_mode, batch_size=2)
    jout = jup.DepthUpscaler(work_dir=str(tmp_path / "jax"), **kw) \
        .process_depth_upscaling(str(depth_dir), str(video), png16_out=True)
    up = tup.DepthUpscaler(work_dir=str(tmp_path / "torch"), device="cpu",
                           **kw)
    tout = up.process_depth_upscaling(str(depth_dir), str(video),
                                      png16_out=True)
    assert up.writer_backend == "png16"
    tag = method + ("_" + guide_mode if method == "guided" else "")
    assert tout.name == f"depth_4k_depth_clip_{tag}"
    a = np.stack([load_depth_png16(f) for f in list_depth_frames(tout)])
    b = np.stack([load_depth_png16(f) for f in list_depth_frames(jout)])
    assert a.shape == b.shape == (5, H_HI, W_HI)
    _cmp(torch.from_numpy(a), b, "uint16")
    if n_video < 5:  # the last batch (frame 4) resized plainly
        plain = tg.plain_upsample(
            torch.from_numpy(load_depth_png16(depth_dir / "depth_000004.png")
                             [None]), H_HI, W_HI, out_dtype="uint16")
        assert np.array_equal(a[4], plain[0].to(torch.int32).numpy())
    # a second run finds the output
    assert up.process_depth_upscaling(str(depth_dir), str(video),
                                      png16_out=True) == tout


def test_upscaler_mp4_and_output_names(tmp_path):
    """ROADMAP C1, repaired in the port: the output names the method and,
    for guided, the guide mode, so one method's result never answers for
    another's."""
    from video3d_tpu_torch.core import get_video_info

    depth_dir, video = _clip(tmp_path)
    names = {}
    for method, mode in (("adaptive", "gray"), ("guided", "gray"),
                         ("guided", "color"), ("scale", "color")):
        up = tup.DepthUpscaler(work_dir=str(tmp_path / "wd"), method=method,
                               guide_mode=mode, device="cpu")
        names[(method, mode)] = up.output_name(depth_dir, png16_out=False)
    assert names == {
        ("adaptive", "gray"): "depth_4k_depth_clip_adaptive.mp4",
        ("guided", "gray"): "depth_4k_depth_clip_guided_gray.mp4",
        ("guided", "color"): "depth_4k_depth_clip_guided_color.mp4",
        ("scale", "color"): "depth_4k_depth_clip_scale.mp4",
    }
    up = tup.DepthUpscaler(work_dir=str(tmp_path / "wd"), device="cpu")
    assert up.method == "adaptive"  # ROADMAP C4: the default
    out = up.process_depth_upscaling(str(depth_dir), str(video))
    assert out.name == "depth_4k_depth_clip_adaptive.mp4" and out.is_file()
    assert up.writer_backend is not None
    info = get_video_info(str(out))
    assert (info["width"], info["height"]) == (W_HI, H_HI)
    # segment-parallel encode: two writer threads, concatenated
    seg = tup.DepthUpscaler(work_dir=str(tmp_path / "seg"), device="cpu",
                            encode_workers=2, preset="ultrafast")
    out = seg.process_depth_upscaling(str(depth_dir), str(video))
    assert seg.writer_backend == "segment-parallel x2"
    info = get_video_info(str(out))
    assert (info["width"], info["height"], info["frames"]) == (W_HI, H_HI, 5)


def test_upscaler_no_silent_cpu_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tup.DepthUpscaler(work_dir=str(tmp_path))
    with pytest.raises(ValueError, match="method"):
        tup.DepthUpscaler(work_dir=str(tmp_path), method="fancy",
                          device="cpu")


def test_upscale_cli_flags(tmp_path, capsys):
    from video3d_tpu_torch.cli.upscale import build_parser, main

    depth_dir, video = _clip(tmp_path)
    args = build_parser().parse_args([str(depth_dir), str(video)])
    assert (args.method, args.guide_mode, args.device, args.batch_size,
            args.radius, args.eps, args.crf, args.preset) == (
        "adaptive", "gray", "cuda", 4, 8, 1e-3, 18, "medium")
    align = tmp_path / "alignment_data.json"
    align.write_text(json.dumps({"time_offset_seconds": 0.0}))
    assert main([str(depth_dir), str(video), "--alignment-file",
                 str(align), "--device", "cpu"]) == 2
    assert "not yet ported" in capsys.readouterr().err
    work = tmp_path / "wd"
    assert main([str(depth_dir), str(video), "--work-dir", str(work),
                 "--method", "guided", "--guide-mode", "color",
                 "--png16-out", "--batch-size", "3", "--radius", "2",
                 "--eps", "0.01", "--max-frames", "4",
                 "--guide-start-frame", "1", "--device", "cpu"]) == 0
    out = work / "depth_4k_depth_clip_guided_color"
    assert "Depth video: " + str(out) in capsys.readouterr().out
    got = np.stack([load_depth_png16(f) for f in list_depth_frames(out)])
    assert got.shape == (4, H_HI, W_HI)
    # the same frames through the op, guide frames 1..4 of the clip
    from video3d_tpu_torch.core import VideoReader

    guide, n = next(iter(VideoReader(str(video), start_frame=1,
                                     max_frames=4, batch_size=4)))
    depth = np.stack([load_depth_png16(f)
                      for f in list_depth_frames(depth_dir)[:4]])
    want = tg.guided_upsample(torch.from_numpy(depth),
                              torch.from_numpy(guide[:n]), H_HI, W_HI,
                              radius=2, eps=0.01, guide_mode="color",
                              out_dtype="uint16")
    assert np.array_equal(got, want.numpy())
