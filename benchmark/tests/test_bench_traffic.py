"""The clip generator: deterministic by seed, its disparities inside the
matcher's range, its SBS formats, and its eyes related by the disparity."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark.harness.registry import BENCH_DIR, Registry
from benchmark.traffic.layered_parallax import render

SMALL = dict(height=48, frames=6, scenes=2)


def _mix(name: str, **kw) -> dict:
    mix = json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())
    mix.update(SMALL, **kw)
    return mix


@pytest.mark.parametrize("name,sbs", [("hsbs", 256), ("fsbs", 512)])
def test_deterministic_by_seed(name, sbs):
    mix = _mix(name, sbs_width=sbs)
    big = 2**40 + 12345  # more than 32 bits, as the driver's seeds are
    a = render(mix, big, "cpu")["frames"]
    b = render(mix, big, "cpu")["frames"]
    c = render(mix, big + 1, "cpu")["frames"]
    assert a.dtype == torch.uint8 and a.shape == (6, 48, sbs, 3)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("name", ["hsbs", "hsbs_k1", "fsbs"])
def test_disparities_inside_the_matcher_range(name):
    reg = Registry()
    mix = _mix(name, sbs_width=512)
    nd = reg.config("stereo_sgbm")["sgbm"]["num_disparities"]
    for seed in (0, 7, 2**33):
        disp = render(mix, seed, "cpu", with_disparity=True)["disparity"]
        w = 512 if mix["format"] == "half_sbs" else 256
        assert disp.shape == (6, 48, w)
        assert float(disp.min()) >= mix["far_disparity"][0] >= 1.0
        assert float(disp.max()) <= mix["slab_disparity"][1] < nd - 1


def test_full_size_mixes_are_1080p():
    for name in ("hsbs", "hsbs_k1", "fsbs"):
        mix = json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())
        assert mix["height"] == 1080 and mix["frames"] % mix["batch"] == 0
        eye = mix["sbs_width"] // 2
        assert eye * (2 if mix["format"] == "half_sbs" else 1) == 1920


def test_right_eye_is_left_shifted_by_disparity():
    """Full-SBS, where the eyes are not squeezed: on rows of the far plane
    alone, the left pixel at x matches the right at x - d for the true d
    (to the interpolation's rounding), and not at x."""
    mix = _mix("fsbs", sbs_width=1024, slabs=0, flat_slabs=0, sky_share=0.0,
               pan_px=0.0)
    out = render(mix, 3, "cpu", with_disparity=True)
    f = out["frames"][0].double()
    left, right = f[:, :512], f[:, 512:]
    d = out["disparity"][0]
    err_match, err_same = [], []
    for y in range(0, 48, 8):
        dy = float(d[y, 0])
        xs = np.arange(80, 500)
        xr = xs - dy
        i0 = np.floor(xr).astype(int)
        t = torch.tensor(xr - i0)
        r = right[y, i0] * (1 - t[:, None]) + right[y, i0 + 1] * t[:, None]
        err_match.append(float((left[y, xs] - r).abs().mean()))
        err_same.append(float((left[y, xs] - right[y, xs]).abs().mean()))
    assert max(err_match) < 2.0
    assert min(err_same) > 3 * max(err_match)
