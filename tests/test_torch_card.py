"""Every CUDA kernel of the port against its plain twin, on the card.

This module imports neither ``jax`` nor ``tests/conftest.py``, so it runs
on a machine that has a CUDA card and no JAX:

    python -m pytest --noconftest tests/test_torch_card.py -m cuda

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false. B1-B4, B8a-c and P run the small-shape lists of
``video3d_tpu_torch/tools/card_checks.py`` (ragged widths, short heights,
D from 16 to 128 (B8a and B8b from 1), ``min_disparity`` 3, every SGM
mode, both accumulator types, f32 and bf16 float costs, 2 bands to one a
disparity; B8b in int16 and f32 from aligned storage and not; P at
ragged shapes, all six ops in one launch and each alone),
B6's level step and B5's EMA step their lists there (guides 5x7 to
540x960); the other kernels
run at the shapes of the ``cuda`` tests beside their CPU tests. Gates are
the smoke's: B1, B2, B4, B8a-c and P bit-exact; B3 identical validity,
disparity within 1e-5, margin within rtol 1e-6, and on its packed route
(``card_checks.B3_PACKED_CASES``) bit-exact against its int32 route
(with the right-image keys) and the twin; B5 1e-5 (its EMA step
1e-4 on unit-scale depth); B6 2e-4 px, its level step too; B7
1e-5 in f32 and one bf16 ulp on >= 99.9% of the outputs. The depth
stage's spans (``core/trace.py``) are held to the device trace's clock on
a 1080p batch of the CREStereo hybrid.
"""

import numpy as np
import pytest
import torch

from video3d_tpu_torch.kernels import (attention, flowmatch, image, sgm,
                                       warp, wmajor)
from video3d_tpu_torch.ops import flow as tflow
from video3d_tpu_torch.ops.attention import attention_plain
from video3d_tpu_torch.tools import card_checks, probe_i16

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _uniform(seed, lo, hi, shape, device):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.uniform(lo, hi, shape).astype(np.float32)).to(
        device)


@pytest.mark.parametrize("case", card_checks.B1_CASES, ids=str)
def test_b1_matches_twin(dev, case):
    card_checks.check_b1(dev, *case)


@pytest.mark.parametrize("case", card_checks.B3_CASES, ids=str)
def test_b3_matches_twin(dev, case):
    card_checks.check_b3(dev, *case)


@pytest.mark.parametrize("case", card_checks.B3_PACKED_CASES, ids=str)
def test_b3_packed_matches_int32_route_and_twin(dev, case):
    card_checks.check_b3_packed(dev, *case)


@pytest.mark.parametrize("case", card_checks.B2_CASES, ids=str)
def test_b2_matches_twin(dev, case):
    card_checks.check_b2(dev, *case)


@pytest.mark.parametrize("case", card_checks.B4_CASES, ids=str)
def test_b4_matches_twin(dev, case):
    card_checks.check_b4(dev, *case)


@pytest.mark.parametrize("shape,r", [((270, 480), 6), ((37, 53), 4),
                                     ((540, 960), 16)])
def test_b5_matches_twin(dev, shape, r):
    img = torch.from_numpy(np.random.default_rng(21).standard_normal(
        shape).astype(np.float32)).to(dev)
    # past the clamp on purpose: both sides must clamp to [-r, r]
    fy = _uniform(22, -r - 1, r + 1, shape, dev)
    fx = _uniform(23, -r - 1, r + 1, shape, dev)
    n = warp.launches
    got = warp.warp_bilinear_shifts(img, fy, fx, r)
    assert warp.launches == n + 1
    want = tflow.warp_bilinear_shifts_plain(img, fy, fx, r)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape", [(270, 480), (37, 53), (5, 7)])
def test_b6_matches_twin(dev, shape):
    def texture(seed):
        """Band-limited random texture: gradient everywhere for matching."""
        import scipy.ndimage as ndi

        t = ndi.gaussian_filter(np.random.default_rng(seed).standard_normal(
            shape), 2.0)
        t = (t - t.min()) / (np.ptp(t) + 1e-9)
        return torch.from_numpy((t * 255.0).astype(np.float32)).to(dev)

    args = (texture(3), texture(4), _uniform(5, -3, 3, shape, dev),
            _uniform(6, -3, 3, shape, dev))
    n = flowmatch.launches
    got = flowmatch.flow_match(*args, search=2, radius=3, tau=2.0)
    assert flowmatch.launches == n + 1
    want = tflow.flow_match_plain(*args, search=2, radius=3, tau=2.0)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 2e-4


@pytest.mark.parametrize("case", card_checks.FLOW_LEVEL_CASES, ids=str)
def test_b6_level_matches_twin(dev, case):
    card_checks.check_flow_level(dev, *case)


@pytest.mark.parametrize("case", card_checks.EMA_CASES, ids=str)
def test_b5_ema_tail_matches_twin(dev, case):
    card_checks.check_ema_tail(dev, *case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 77, 32), (1, 6, 130, 16),
                                   (2, 16, 577, 64), (1, 4, 1500, 32)])
def test_b7_matches_twin(dev, dtype, shape):
    r = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(r.standard_normal(shape).astype(
        np.float32)).to(dev, dtype) for _ in range(3))
    sm = 1.0 / shape[-1] ** 0.5
    want = attention_plain(q, k, v, sm).float()
    n = attention.launches
    for got in (attention.attention_multihead(q, k, v, sm),
                attention.attention_oneblock(q, k, v, sm)):
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        if dtype == torch.float32:
            assert err.max().item() <= 1e-5
        else:
            tol = 2.0 ** -7 * want.abs() + 2.0 ** -10
            assert (err <= tol).float().mean().item() >= 0.999
    assert attention.launches == n + 2


@pytest.mark.parametrize("case", card_checks.B8A_CASES, ids=str)
def test_b8a_matches_twin(dev, case):
    card_checks.check_b8a(dev, *case)


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
def test_b8b_matches_twin(dev, dtype):
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.integers(0, 30000, (2, 70, 90, 40))).to(dev, dtype)
    n = wmajor.transpose_launches
    t = wmajor.transpose_to_wmajor(x)
    assert torch.equal(t, wmajor.transpose_to_wmajor_plain(x))
    assert torch.equal(wmajor.transpose_from_wmajor(t, 70), x)
    assert wmajor.transpose_launches > n


@pytest.mark.parametrize("cost_dtype,acc_dtype",
                         [(torch.int16, torch.int16),
                          (torch.int16, torch.float32),
                          (torch.float32, torch.float32)])
@pytest.mark.parametrize("reverse", [False, True])
def test_b8c_matches_twin(dev, reverse, cost_dtype, acc_dtype):
    r = np.random.default_rng(2)
    cost_t = torch.from_numpy(r.integers(0, 1550, (2, 64, 90, 70))).to(
        dev, cost_dtype)
    acc = torch.from_numpy(r.integers(0, 10000, cost_t.shape)).to(
        dev, acc_dtype)
    want = wmajor.wmajor_sweep_plain(cost_t, acc, 600.0, 2400.0, reverse)
    n = wmajor.sweep_launches
    got = wmajor.wmajor_sweep(cost_t, acc.clone(), 600.0, 2400.0, reverse)
    assert wmajor.sweep_launches == n + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", card_checks.B8C_CASES, ids=str)
def test_b8c_cases_match_twin(dev, case):
    card_checks.check_b8c(dev, *case)


@pytest.mark.parametrize("types", ["i16", "f32"])
@pytest.mark.parametrize("case", card_checks.B8B_CASES, ids=str)
def test_b8b_cases_match_twin(dev, case, types):
    card_checks.check_b8b(dev, *case, types)


def test_probe_ops_match_torch(dev):
    n = probe_i16.launches
    assert all(v == 0 for v in probe_i16.run(dev).values())
    assert probe_i16.launches == n + 2  # one launch a set of inputs


@pytest.mark.parametrize("shape", card_checks.P_CASES, ids=str)
def test_p_cases_match_torch(dev, shape):
    card_checks.check_p(dev, shape)


@pytest.mark.parametrize("case", card_checks.I1_CASES, ids=str)
def test_i1_matches_twin(dev, case):
    card_checks.check_i1(dev, *case)


def _stage_frames(dev, b=2, h=40, w=160, seed=21):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.integers(0, 256, (b, h, w, 3),
                                       dtype=np.uint8)).to(dev)


def test_i1_one_launch_a_stage_call(dev):
    from video3d_tpu_torch.ops.stereo import SGBMParams
    from video3d_tpu_torch.stages.depth import depth_batch_pipeline

    frames = _stage_frames(dev)
    p = SGBMParams(num_disparities=16)

    def mono(left):  # a guide that reads the RGB left eye
        return left.mean(dim=-1)

    for opts in (dict(), dict(unsqueeze=False), dict(guidance_fn=mono),
                 dict(guidance_fn=mono, unsqueeze=False, return_guide=True)):
        n = image.launches
        depth_batch_pipeline(frames, params=p, **opts)
        assert image.launches == n + 1, opts


def test_i1_stage_ignores_tf32(dev):
    """No f32 matrix product is left on the stereo stage's path: with
    TF32 allowed its output is the same to the bit."""
    from video3d_tpu_torch.ops.stereo import SGBMParams
    from video3d_tpu_torch.stages.depth import depth_batch_pipeline

    frames = _stage_frames(dev, b=2, h=64, w=512)
    p = SGBMParams(num_disparities=32)
    old = torch.backends.cuda.matmul.allow_tf32
    outs = []
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            outs.append([depth_batch_pipeline(frames, params=p),
                         *image.eyes_gray(frames, want_rgb=True)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_spans_share_the_device_trace_clock(dev):
    """The stage's spans on a 1080p batch of the CREStereo hybrid under a
    CPU+CUDA profile: ``matcher.speckle``'s host interval holds B4's
    ``cudaLaunchKernel`` event, and the stage's child spans' device times
    add up to the stage's within 5%."""
    from torch.profiler import ProfilerActivity, profile

    from video3d_tpu_torch.core import trace
    from video3d_tpu_torch.models.crestereo import load_crestereo_guidance
    from video3d_tpu_torch.stages.depth import depth_batch_pipeline
    from video3d_tpu_torch.tools.time_kernels import sbs_batch

    frames = torch.from_numpy(sbs_batch(8)).to(dev)
    opts = dict(guidance_fn=load_crestereo_guidance(device=dev),
                guidance_every=4, fill_holes=True)
    depth_batch_pipeline(frames, **opts)  # builds, plans, warms
    torch.cuda.synchronize()
    trace.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                depth_batch_pipeline(frames, **opts)
            torch.cuda.synchronize()
        recs = trace.records()
    finally:
        trace.reset()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    b4 = {e.correlation_id() for e in events
          if e.device_type() == cuda and "speckle_kernel" in e.name()}
    launches = [(e.start_ns(), e.start_ns() + e.duration_ns())
                for e in events if e.device_type() != cuda
                and "LaunchKernel" in e.name() and e.correlation_id() in b4]
    speckle = [r for r in recs if r["name"] == "matcher.speckle"]
    assert b4 and len(launches) == len(b4) and len(speckle) == 2
    for a, b in launches:
        assert any(r["start_ns"] <= a and b <= r["end_ns"] for r in speckle)
    assert all(any(r["start_ns"] <= a and b <= r["end_ns"]
                   for a, b in launches) for r in speckle)
    stages = [i for i, r in enumerate(recs) if r["name"] == "stage"]
    assert len(stages) == 2
    for i in stages:
        kids = [r["device_ms"] for r in recs if r["parent"] == i]
        assert all(ms is not None for ms in kids) and len(kids) == 5
        assert abs(sum(kids) - recs[i]["device_ms"]) <= \
            0.05 * recs[i]["device_ms"], (sum(kids), recs[i]["device_ms"])
