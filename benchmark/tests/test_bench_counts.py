"""The yardstick's arithmetic against hand-worked values and against the
port's own count it was frozen from."""

from __future__ import annotations

import dataclasses

import pytest

from benchmark.harness import work
from benchmark.harness.registry import Registry


def test_matcher_bytes_hand_worked():
    """1080p, D=64, one frame: B1 reads two f32 eyes and writes the int16
    volume, B2 reads it and writes int16 sums, B3 reads both and writes the
    f32 disparity, B4 reads and writes it: 0.4086 ms at 3.35 TB/s."""
    pix, vol = 1080 * 1920, 1080 * 1920 * 64
    assert pix == 2_073_600 and vol == 132_710_400
    by = {k: b for k, (b, _) in work.matcher_work(1, 1080, 1920, 64,
                                                  False).items()}
    assert by == {"B1": 16_588_800 + 265_420_800, "B2": 530_841_600,
                  "B3": 530_841_600 + 8_294_400, "B4": 16_588_800}
    ms = work.matcher_least_ms(1, 1080, 1920, 64, False)
    assert ms == pytest.approx(1_368_576_000 / 3.35e12 * 1e3)
    assert round(ms, 4) == 0.4085
    # every kernel is bound by its bytes, not its operations
    for b, o in work.matcher_work(1, 1080, 1920, 64, False).values():
        assert b / work.HBM_BYTES_S > o / work.PEAK_OPS_S["f32"]
    # the hybrid's B3 also writes the f32 margin; batch scales linearly
    assert work.matcher_least_ms(8, 1080, 1920, 64, True) == pytest.approx(
        8 * (1_368_576_000 + 8_294_400) / 3.35e12 * 1e3)


def _crestereo_lite():
    reg = Registry()
    return reg.guide("crestereo_lite"), reg.config("crestereo_hybrid")["guide"]


def test_conv_flops_equal_the_ports():
    from video3d_tpu_torch.models.crestereo import CREStereoConfig, conv_flops

    kind, guide = _crestereo_lite()
    assert kind.conv_flops(guide, 540, 960) == conv_flops(CREStereoConfig(),
                                                          540, 960)
    assert round(kind.conv_flops(guide, 540, 960) / 1e9, 1) == 164.8
    tiny = CREStereoConfig.tiny()
    as_dict = dataclasses.asdict(tiny)
    for h, w in ((37, 101), (64, 128), (541, 963)):
        assert kind.conv_flops(as_dict, h, w) == conv_flops(tiny, h, w)


def test_step_arithmetic_hand_worked():
    kind, guide = _crestereo_lite()
    assert kind.keyframe_shape(1080, 1920, 2) == (540, 960)
    assert kind.keyframe_shape(540, 960, 2) == (540, 960)
    # 16 shifts of a 64-wide dot product at 135 x 240
    assert kind.corr_flops(guide, 540, 960) == 2 * 64 * 135 * 240 * 16
    assert kind.work(guide, 1080, 1920) == {
        "bf16": kind.conv_flops(guide, 540, 960),
        "f32": kind.corr_flops(guide, 540, 960)}
    vol = 8 * 1080 * 1920 * 64
    ops = (20 + 18 + 35) * vol + 19 * 8 * 1080 * 1920
    stereo = work.step_least_ms(8, 1080, 1920, 64, 0, None)
    assert stereo == pytest.approx(ops / 67e12 * 1e3)
    k4 = work.step_least_ms(8, 1080, 1920, 64, 2,
                            kind.work(guide, 1080, 1920))
    assert k4 - stereo == pytest.approx(
        2 * (kind.conv_flops(guide, 540, 960) / 989e12
             + kind.corr_flops(guide, 540, 960) / 67e12) * 1e3)
