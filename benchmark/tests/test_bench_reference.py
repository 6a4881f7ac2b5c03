"""The reference against the port's CPU path (its plain twins) at a tiny size,
and the control one precision lower against both."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import check, driver
from benchmark.reference.depth import fill_holes, to_uint16
from benchmark.reference.matcher import box_clipped

CONFIGS = ["crestereo_hybrid", "stereo_sgbm"]


def _program_and_frames(reg, config_name):
    config = reg.config(config_name)
    traffic = reg.traffic("tiny")
    stage, _, opts = driver.build(reg, config, traffic, "cpu")
    frames = reg.generator(traffic["generator"])(traffic, 2**35 + 1,
                                                 "cpu")["frames"]
    return config, traffic, stage.depth_batch_pipeline(frames, **opts), frames


@pytest.mark.parametrize("config_name", CONFIGS)
def test_reference_agrees_with_the_port_on_cpu(tiny_reg, config_name):
    config, traffic, maps, frames = _program_and_frames(tiny_reg,
                                                        config_name)
    ref = check.reference(tiny_reg, config, traffic, "cpu").maps(frames)
    got = check.numbers(maps, ref, config["sgbm"]["num_disparities"])
    # float64 reference steps against the port's float32 ones: a few
    # sub-pixel rounding flips, no disparity off by a pixel or more
    assert got["mean_px"] < 0.01
    assert got["worst_off_pct"] < 0.5
    # the maps are not trivial: most pixels hold a match or a fill
    assert float((ref > 0).double().mean()) > 0.5

    ctl = check.reference(tiny_reg, config, traffic, "cpu",
                          control=True).maps(frames)
    low = check.numbers(ctl, ref, config["sgbm"]["num_disparities"])
    assert low["mean_px"] > 10 * max(got["mean_px"], 1e-4)


def test_fill_and_uint16_by_hand():
    inv = -1.0
    d = torch.tensor([[[inv, 5.0, inv, inv, 3.0, inv]]])
    assert fill_holes(d, inv).tolist() == [[[5.0, 5.0, 3.0, 3.0, 3.0, 3.0]]]
    blank = torch.full((1, 1, 3), inv)
    assert torch.equal(fill_holes(blank, inv), blank)
    q = to_uint16(torch.tensor([[[-2.0, 0.0, 1.0, 64.0, 70.0]]]), 64, "fixed")
    assert q.tolist() == [[[0, 0, 1023, 65535, 65535]]]


def test_box_clipped_by_hand():
    x = torch.arange(1.0, 6.0).view(1, 1, 5)
    # rows of one: only the width sums, clipped at the borders
    assert box_clipped(x, 1).tolist() == [[[3.0, 6.0, 9.0, 12.0, 9.0]]]
    ones = torch.ones(1, 4, 4)
    assert box_clipped(ones, 1)[0, 0].tolist() == [4.0, 6.0, 6.0, 4.0]
