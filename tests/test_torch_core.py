"""The port's own host layer (``video3d_tpu_torch.core``) vs the JAX one.

On conftest's ``make_test_video`` clip: the same ``get_video_info``, the
same decoded frames from ``VideoReader`` (tail batch included), the same
PNG16 bytes from ``DepthMapWriter`` and ``save_depth_png16`` (native and
OpenCV encoders alike), and the same cache keys and directory layout.
"""

import numpy as np
import pytest

from tests.conftest import make_test_video
from video3d_tpu import core as jcore
from video3d_tpu.core import cache as jcache
from video3d_tpu_torch import core as tcore
from video3d_tpu_torch.core import cache as tcache


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("clip") / "clip.mp4"
    make_test_video(path, n_frames=7, width=64, height=32)
    return path


def test_video_info_matches(clip):
    assert tcore.get_video_info(str(clip)) == jcore.get_video_info(str(clip))
    assert tcore.get_video_info(str(clip.with_name("none.mp4"))) is None


@pytest.mark.parametrize("start,max_frames,batch", [(0, None, 3), (2, 4, 8)])
def test_decoded_frames_match(clip, start, max_frames, batch):
    def frames(mod):
        return [(b.copy(), v) for b, v in mod.VideoReader(
            str(clip), start_frame=start, max_frames=max_frames,
            batch_size=batch)]

    want, got = frames(jcore), frames(tcore)
    assert [v for _, v in got] == [v for _, v in want]
    assert sum(v for _, v in got) == (max_frames or 7 - start)
    for (a, _), (b, _) in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("native", [True, False])
def test_png16_bytes_match(tmp_path, monkeypatch, native):
    if not native:
        # the OpenCV encoder of both layers
        from video3d_tpu.core import _native as jn
        from video3d_tpu_torch.core import _native as tn

        for mod in (jn, tn):
            monkeypatch.setattr(mod, "lib", lambda: None)
    r = np.random.default_rng(3)
    batch = r.integers(0, 65536, (4, 24, 40)).astype(np.uint16)
    for mod, sub in ((jcore, "jax"), (tcore, "torch")):
        with mod.DepthMapWriter(tmp_path / sub) as w:
            w.put(batch, 5, 3)
    jfiles = jcore.list_depth_frames(tmp_path / "jax")
    tfiles = tcore.list_depth_frames(tmp_path / "torch")
    assert [f.name for f in tfiles] == [f.name for f in jfiles] == [
        "depth_000005.png", "depth_000006.png", "depth_000007.png"]
    for a, b, want in zip(tfiles, jfiles, batch):
        assert a.read_bytes() == b.read_bytes()
        np.testing.assert_array_equal(tcore.load_depth_png16(a), want)
    tcore.save_depth_png16(tmp_path / "one_t.png", batch[3])
    jcore.save_depth_png16(tmp_path / "one_j.png", batch[3])
    assert ((tmp_path / "one_t.png").read_bytes()
            == (tmp_path / "one_j.png").read_bytes())
    assert tcache.is_depth_cached_range(tmp_path / "torch", 5, 3)
    assert not tcache.is_depth_cached_range(tmp_path / "torch", 4, 3)


def test_cache_keys_match(tmp_path):
    args = (str(tmp_path), "/videos/film.mp4", 24, 120,
            "stereo_only+a2+torch", True)
    assert tcore.depth_cache_dir(*args) == jcore.depth_cache_dir(*args)
    assert tcore.content_key("a", 1, 2.5) == jcore.content_key("a", 1, 2.5)
    assert tcache.depth_frame_name(42) == jcache.depth_frame_name(42)
    assert tcache.is_depth_cached(tmp_path, 0)
    work = tcore.create_work_directory(str(tmp_path / "w" / "x"))
    assert work.is_dir()
