"""Every CUDA kernel of the port against its plain twin, on the card.

This module imports neither ``jax`` nor ``tests/conftest.py``, so it runs
on a machine that has a CUDA card and no JAX:

    python -m pytest --noconftest tests/test_torch_card.py -m cuda

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false. Each kernel runs its case list of
``video3d_tpu_torch/tools/card_checks.py`` (small and ragged shapes, then
the main path's: 1080p half-SBS at batch 2 and 8, DPT-large's attention,
the flow path's planes), one test a case, through its ``check_*``
function. Gates: B1, B2, B4, B8a-c, P and B3's packed route bit-exact; B3
identical validity, disparity within 1e-5, margin within rtol 1e-6; B5
1e-5 (its EMA step 1e-4 on unit-scale depth); B6 2e-4 px, its level step
too; B7 1e-5 in f32 and one bf16 ulp on >= 99.9% of the outputs; I1 1e-3.
The depth stage's spans (``core/trace.py``) are held to the device
trace's clock on a 1080p batch of the CREStereo hybrid.
"""

import numpy as np
import pytest
import torch

from video3d_tpu_torch.kernels import image
from video3d_tpu_torch.tools import card_checks, probe_i16

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


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


@pytest.mark.parametrize("case", card_checks.B5_CASES, ids=str)
def test_b5_matches_twin(dev, case):
    card_checks.check_b5(dev, *case)


@pytest.mark.parametrize("case", card_checks.B6_CASES, ids=str)
def test_b6_matches_twin(dev, case):
    card_checks.check_b6(dev, *case)


@pytest.mark.parametrize("case", card_checks.FLOW_LEVEL_CASES, ids=str)
def test_b6_level_matches_twin(dev, case):
    card_checks.check_flow_level(dev, *case)


@pytest.mark.parametrize("case", card_checks.EMA_CASES, ids=str)
def test_b5_ema_tail_matches_twin(dev, case):
    card_checks.check_ema_tail(dev, *case)


@pytest.mark.parametrize("case", card_checks.B7_CASES, ids=str)
def test_b7_matches_twin(dev, case):
    card_checks.check_b7(dev, *case)


@pytest.mark.parametrize("case", card_checks.B8A_CASES, ids=str)
def test_b8a_matches_twin(dev, case):
    card_checks.check_b8a(dev, *case)


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

    frames = torch.from_numpy(card_checks.sbs_batch(8)).to(dev)
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
