"""The port's paths on the card, through the entry points a user calls.

Like ``tests/test_torch_card.py`` this module imports neither ``jax`` nor
``tests/conftest.py``:

    python -m pytest --noconftest tests/test_torch_card_paths.py -m cuda

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false. Each sets the launch counters of the kernel wrappers to 0 before
its path and fails if a kernel of the path never ran. The paths run 1080p
SBS frames whose eyes are ``SHIFT_EYE`` pixels apart (16 px of disparity
after the 2x unsqueeze): the stereo-only stage to PNG16 against the plain
path, the flow-smoothed stage on a panning clip, the DPT hybrid from the
benchmark's seeded DPT-large checkpoint at K = 4 and K = 1, MODE_HH, both
W-major routes against legacy, ``sgm_aggregate_pallas`` through its public
entry, the int16 probe's own run, the CREStereo hybrid (the shipped
default, K = 4, and K = 1; bf16 on the card against f32 on the CPU), the
published CREStereo from the benchmark's seeded weights as the hybrid's
guide at K = 4 and K = 1 (bf16 on the card against the float32 reference)
and the 4K upscale (each upsample against its CPU run; ``DepthUpscaler`` to
PNG16 and to mp4).
"""

import contextlib

import numpy as np
import pytest
import torch

import video3d_tpu_torch.kernels as kernels_api
from video3d_tpu_torch.core import (VideoWriter, list_depth_frames,
                                    load_depth_png16)
from video3d_tpu_torch.kernels import (agcl, attention, blend, costvol,
                                       flowmatch, image, sgm, speckle, warp,
                                       wmajor)
from video3d_tpu_torch.ops.fill import fill_holes
from video3d_tpu_torch.ops.image import (eyes_gray_plain, resize2d, rgb_eyes,
                                         rgb_to_gray)
from video3d_tpu_torch.ops.speckle import speckle_filter_device
from video3d_tpu_torch.ops.stereo import INVALID, SGBMParams, sgbm_disparity
from video3d_tpu_torch.stages.depth import (StereoDepthExtractor,
                                            blend_plain,
                                            depth_batch_pipeline,
                                            disparity_to_uint16,
                                            guidance_blend)
from video3d_tpu_torch.tools import probe_i16
from video3d_tpu_torch.tools.card_checks import profile_kernels, sbs_batch

pytestmark = pytest.mark.cuda

H, W_SBS = 1080, 1920
SHIFT_EYE = 8  # eye pixels; 16 px disparity after the 2x unsqueeze
PAN_EYE = 2  # eye pixels per frame of the panning clip: 1 px at the 1/4 guide
SEED = 0
P, P8 = SGBMParams(), SGBMParams(num_paths=8)
COUNTERS = {  # kernel -> (wrapper module, its launch count)
    "B1": (costvol, "launches"), "B2": (sgm, "sweep_launches"),
    "B3": (sgm, "wta_launches"), "B4": (speckle, "launches"),
    "B3-packed": (sgm, "vertical_packed_launches"),
    "B5": (warp, "launches"), "B6": (flowmatch, "launches"),
    "B7": (attention, "launches"), "B8a": (sgm, "aggregate_launches"),
    "B8b": (wmajor, "transpose_launches"),
    "B8c": (wmajor, "sweep_launches"), "P": (probe_i16, "launches"),
    "I1": (image, "launches"), "F": (blend, "launches"),
    "A1": (agcl, "launches"),
}


def counts(reset: bool = False) -> dict:
    if reset:
        for mod, attr in COUNTERS.values():
            setattr(mod, attr, 0)
    return {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}


def ran(keys, what: str) -> list:
    """The launch counts of ``keys``; fails if one is 0."""
    n = [counts()[k] for k in keys]
    assert all(k > 0 for k in n), \
        f"a kernel never ran on {what}: {dict(zip(keys, n))}"
    return n


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.cuda.empty_cache()
    return torch.device("cuda")


def sbs_frames(n: int, seed: int) -> np.ndarray:
    """(n, 1080, 1920, 3) uint8 SBS frames, the eyes SHIFT_EYE apart."""
    return sbs_batch(n, seed, H, W_SBS // 2, SHIFT_EYE)


def pan_frames(n: int, seed: int) -> np.ndarray:
    """(n, 1080, 1920, 3) uint8 SBS frames of one random texture (2-pixel
    grain) panning PAN_EYE eye pixels per frame: frame t's left eye is
    base[:, PAN_EYE*t:], so cur(x) = prev(x + PAN_EYE) (backward flow
    +PAN_EYE). The right eye is the left shifted by SHIFT_EYE."""
    rng = np.random.default_rng(seed)
    w_eye = W_SBS // 2
    span = w_eye + SHIFT_EYE + PAN_EYE * n
    base = rng.integers(0, 256, (H // 2, span // 2 + 1, 3), dtype=np.uint8)
    base = np.repeat(np.repeat(base, 2, axis=0), 2, axis=1)[:H, :span]
    out = np.empty((n, H, W_SBS, 3), dtype=np.uint8)
    for t in range(n):
        x0 = PAN_EYE * t
        out[t, :, :w_eye] = base[:, x0:x0 + w_eye]
        out[t, :, w_eye:] = base[:, x0 + SHIFT_EYE:x0 + SHIFT_EYE + w_eye]
    return out


def dpt_checkpoint(device):
    """(directory, guide, kind) of the benchmark's ``dpt_large_hybrid``
    configuration: its HF checkpoint directory, written from its seed under
    ``TMPDIR`` on first use (``benchmark/harness/weights.py``), its guide
    widths and its guide kind, whose ``check`` the loaded guide must pass."""
    from benchmark.harness import weights
    from benchmark.harness.registry import Registry

    reg = Registry()
    config = reg.config("dpt_large_hybrid")
    kind = reg.guide(config["guide"]["kind"])
    return (weights.path(kind, config, reg.root, device), config["guide"],
            kind)


def published_checkpoint(device):
    """(weights file, guide, kind) of the benchmark's
    ``crestereo_published_hybrid`` configuration: the published CREStereo's
    ``state_dict`` written from its seed under ``TMPDIR`` on first use."""
    from benchmark.harness import weights
    from benchmark.harness.registry import Registry

    reg = Registry()
    config = reg.config("crestereo_published_hybrid")
    kind = reg.guide(config["guide"]["kind"])
    return (weights.path(kind, config, reg.root, device), config["guide"],
            kind)


@contextlib.contextmanager
def twins():
    """Swap the wrappers of B1-B4, B7, I1, F1, F2 and A1 for their plain
    twins, so the stage's own code runs on the card with no CUDA kernel of
    the port."""
    from video3d_tpu_torch.models.crestereo_net import (agcl_deformable,
                                                        agcl_warped)
    from video3d_tpu_torch.ops.attention import attention_plain

    def agcl_twin(f1, f2, flow, offset, small, groups, out=None):
        if offset is None:
            return agcl_warped(f1, f2, flow, small, groups)
        return agcl_deformable(f1, f2, flow, offset, small, groups)

    swaps = (
        (costvol, "cost_volume", costvol.cost_volume_plain),
        (sgm, "horizontal_sweeps", sgm.horizontal_sweeps_plain),
        (sgm, "vertical_sweeps_wta", sgm.vertical_sweeps_wta_plain),
        (speckle, "speckle_filter", speckle_filter_device),
        (image, "eyes_gray", eyes_gray_plain),
        (attention, "attention_multihead",
         lambda q, k, v, sm_scale, heads_per_step=8:
         attention_plain(q, k, v, sm_scale)),
        (blend, "fill_holes", fill_holes),
        (blend, "trust_blend",
         lambda disp, margin, out, every, stereo, nd, md: blend_plain(
             disp, margin, out, every, stereo,
             SGBMParams(num_disparities=nd, min_disparity=int(md)))),
        (agcl, "correlate", agcl_twin),
    )
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_depth(frames_np, device, params=P):
    """uint16 maps and left gray of the depth path on the plain twins."""
    x = torch.from_numpy(frames_np).to(device)
    gl, gr = eyes_gray_plain(x)[:2]
    cost = costvol.cost_volume_plain(gl, gr, params,
                                     2.0 * params.prefilter_cap)
    disp = sgm.vertical_sweeps_wta_plain(
        cost, sgm.horizontal_sweeps_plain(cost, params), params)
    disp = speckle_filter_device(disp, INVALID(params),
                                 float(params.speckle_range),
                                 params.speckle_window_size,
                                 (0.0, float(params.num_disparities)))
    return disparity_to_uint16(disp, params.num_disparities), gl


def as_int(t: torch.Tensor) -> np.ndarray:
    """A uint16 tensor's values as an int32 array."""
    return t.cpu().to(torch.int32).numpy()


def read_maps(cache, n: int) -> np.ndarray:
    files = list_depth_frames(cache)
    assert len(files) == n, f"{len(files)} PNGs for {n} frames"
    maps = np.stack([load_depth_png16(f) for f in files])
    assert maps.shape == (n, H, W_SBS) and maps.dtype == np.uint16
    return maps


def median_px(maps) -> float:
    return float(np.median(maps.astype(np.float64) * (P.num_disparities
                                                      / 65535.0)))


def check_disparity(maps, what: str) -> None:
    """Most pixels valid, the median at the eyes' shift."""
    frac = float((maps > 0).mean())
    assert 0.5 < frac <= 1.0, f"{what}: valid fraction {frac}"
    med = median_px(maps[maps > 0])
    assert abs(med - 2 * SHIFT_EYE) <= 0.5, f"{what}: median disparity {med}"


def run_stage(ext, batches, cache) -> int:
    """``_run_batches`` with the launch counters set to 0 first."""
    counts(reset=True)
    return ext._run_batches(batches, cache)


@contextlib.contextmanager
def b7_calls():
    """The (shape, dtype) of every B7 call made inside the block."""
    calls, fn = [], attention.attention_multihead

    def record(q, k, v, sm_scale, heads_per_step=8):
        calls.append((tuple(q.shape), q.dtype))
        return fn(q, k, v, sm_scale, heads_per_step)

    attention.attention_multihead = record
    try:
        yield calls
    finally:
        attention.attention_multihead = fn


def fused_stage(x0, gfn, kev) -> tuple:
    """(F launches, ``stage.blend``'s ``fused`` count) of one guided stage
    call with the fill, its spans recorded under a CPU profile."""
    from torch.profiler import ProfilerActivity, profile

    from video3d_tpu_torch.core import trace

    n = blend.launches
    trace.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            depth_batch_pipeline(x0, guidance_fn=gfn, guidance_every=kev,
                                 fill_holes=True)
        fused = trace.summary()["stage.blend"]["counts"]["fused"]
    finally:
        trace.reset()
    return blend.launches - n, fused


def check_guided_batch(x0, gfn, maps8, kev) -> tuple:
    """A guided batch at K = ``kev`` step by step on the kernels (no hole
    left in a row with a valid pixel, a finite blend, the run's maps within
    1 unit; one stage call through F1 and F2, every frame counted
    ``fused``), then with every kernel swapped for its twin (no launch; >=
    99% of the pixels within 64 units, 1/16 px). Returns (left, right)
    eyes."""
    left, right = rgb_eyes(x0)
    disp, conf = sgbm_disparity(rgb_to_gray(left).contiguous(),
                                rgb_to_gray(right).contiguous(), P,
                                return_margin=True)
    invalid = float(P.min_disparity - 1)
    filled = fill_holes(disp, invalid)
    rows_valid = (disp != invalid).any(-1, keepdim=True)
    assert int(((filled == invalid) & rows_valid).sum().item()) == 0
    blended = guidance_blend(filled, conf, left, right, gfn, P,
                             guidance_every=kev)
    assert bool(torch.isfinite(blended).all()), "blend not finite"
    step = as_int(disparity_to_uint16(blended, P.num_disparities))
    assert int(np.abs(step - maps8.astype(np.int32)).max()) <= 1
    n_f = 1 + (2 if getattr(gfn, "stereo", False) else 3)
    assert fused_stage(x0, gfn, kev) == (n_f, x0.shape[0])
    with twins():
        counts(reset=True)
        tmaps = as_int(depth_batch_pipeline(
            x0, guidance_fn=gfn, guidance_every=kev, fill_holes=True))
        assert not any(counts().values()), f"twin run launched {counts()}"
    within = float((np.abs(tmaps - maps8.astype(np.int32)) <= 64).mean())
    assert within >= 0.99, f"vs twins: {within} within 64"
    return left, right


def test_stereo_path_matches_plain(dev, tmp_path):
    ext = StereoDepthExtractor(work_dir=str(tmp_path), guidance="none",
                               device=dev)
    batch = ext._auto_batch_size(H, W_SBS)
    batches = [(sbs_frames(batch, SEED + 1 + i), batch) for i in range(2)]
    n = run_stage(ext, batches, tmp_path / "depth")
    b3 = ran(("B1", "B2", "B3", "B4"), "the stereo path")[2]
    assert counts()["B3-packed"] == b3, "B3 left the packed route"
    assert counts()["I1"] == n // batch, "I1 is not one launch a batch"
    assert n == 2 * batch
    maps = read_maps(tmp_path / "depth", n)
    check_disparity(maps, "stereo path")
    plain, _ = plain_depth(batches[0][0], dev)
    assert np.array_equal(as_int(plain), maps[:batch])


def test_flow_path_on_a_pan(dev, tmp_path):
    from video3d_tpu_torch.ops.flow import FlowEMAParams, estimate_flow_fast
    from video3d_tpu_torch.parallel.temporal import TemporalFlowEMAStream

    ext = StereoDepthExtractor(work_dir=str(tmp_path), guidance="none",
                               device=dev, temporal_smooth="flow")
    batch = ext._auto_batch_size(H, W_SBS)
    clip = pan_frames(2 * batch, SEED + 10)
    batches = [(clip[i * batch:(i + 1) * batch], batch) for i in range(2)]
    n = run_stage(ext, batches, tmp_path / "depth")
    ran(("B1", "B2", "B3", "B4", "B5", "B6"), "the flow path")
    assert n == 2 * batch
    maps = read_maps(tmp_path / "depth", n)
    check_disparity(maps, "flow path")
    # frame 0 passes through: the unsmoothed map of the kernel path
    raw, guide0 = depth_batch_pipeline(
        torch.from_numpy(batches[0][0]).to(dev), return_guide=True)
    assert np.array_equal(as_int(raw[0]), maps[0])
    # the motion of the pan on two consecutive guides (1/4 scale)
    rq = max(1, int(round(FlowEMAParams().max_warp / 4)))
    fy, fx = estimate_flow_fast(guide0[1], guide0[0], max_flow=rq)
    assert abs(fx.median().item() - 2 * PAN_EYE / 4) <= 0.25
    assert abs(fy.median().item()) <= 0.25
    # batch 0 on the plain twins: the depth twins on the card, the
    # smoother's on the CPU
    pmaps, pgl = plain_depth(batches[0][0], dev)
    assert int((pmaps != raw).sum().item()) == 0, "raw maps differ from plain"
    pguide = resize2d(pgl, -(-H // 4), -(-W_SBS // 4), "bilinear")
    twin = TemporalFlowEMAStream().push(pmaps.cpu(), pguide.cpu())
    d = np.abs(twin.to(torch.int32).numpy() - maps[:batch].astype(np.int32))
    assert float((d <= 16).mean()) >= 0.999, "smoother vs its twins"


def test_flow_smoother_device_operations(dev):
    """The smoother alone, shaped as the JAX package's bench_smooth (T=8
    uint16 1080p depth, 270x480 guide): at most 20 device operations a
    frame in a ``torch.profiler`` trace."""
    from video3d_tpu_torch.ops.flow import FlowEMAParams, flow_ema_scan

    r = np.random.default_rng(2)
    sd = torch.from_numpy(r.integers(0, 65535, (8, H, W_SBS))
                          .astype(np.uint16)).to(dev)
    sg = torch.from_numpy(r.integers(0, 255, (8, 270, 480))
                          .astype(np.float32)).to(dev)
    n_dev, _ = profile_kernels(
        lambda: flow_ema_scan(None, sd, sg, FlowEMAParams()), 1)
    assert 0 < n_dev <= 20 * 8, f"{n_dev / 8:.2f} device operations a frame"


@pytest.mark.parametrize("kev", [4, 1])
def test_dpt_hybrid_path(dev, tmp_path, kev):
    """K = 4 and K = 1 (the cell dpt_hybrid_k1_hsbs): one ViT forward of
    the batch's 8 / K keyframes, 24 B7 calls at (8 / K, 16, 577, 64)."""
    dpt_dir, guide, kind = dpt_checkpoint(dev)
    ext = StereoDepthExtractor(work_dir=str(tmp_path), guidance="dpt",
                               model_checkpoint=str(dpt_dir), batch_size=8,
                               guidance_every=kev, device=dev)
    ext.load_model()
    gfn = ext._guidance_fn
    assert gfn is not None, "the DPT checkpoint did not load"
    kind.check(gfn, guide)
    batches = [(sbs_frames(8, SEED + 20 + i), 8) for i in range(2)]
    with b7_calls() as calls:
        n = run_stage(ext, batches, tmp_path / "depth")
    c = counts()
    launches = [c[k] for k in ("B1", "B2", "B3", "B4", "B5", "B6", "B7",
                               "F")]
    assert n == 16
    # 24 B7 a batch; F1's fill, statistics and agreement, then F2
    assert launches == [2, 2, 2, 2, 0, 0, 2 * 24, 2 * 4], launches
    assert calls == [((8 // kev, 16, 577, 64), torch.bfloat16)] * 48, \
        sorted(set(calls), key=str)
    maps = read_maps(tmp_path / "depth", n)
    assert abs(median_px(maps[:8]) - 2 * SHIFT_EYE) <= 0.5
    check_guided_batch(torch.from_numpy(batches[0][0]).to(dev), gfn,
                       maps[:8], kev)


def test_mode_hh_path_matches_plain(dev, tmp_path):
    ext = StereoDepthExtractor(work_dir=str(tmp_path), guidance="none",
                               batch_size=8, device=dev, params=P8)
    batches = [(sbs_frames(8, SEED + 30 + i), 8) for i in range(2)]
    n = run_stage(ext, batches, tmp_path / "depth")
    ran(("B1", "B2", "B3", "B4"), "the MODE_HH path")
    assert counts()["B3-packed"] == 0, "MODE_HH took B3's packed route"
    assert n == 16
    maps = read_maps(tmp_path / "depth", n)
    check_disparity(maps, "MODE_HH path")
    counts(reset=True)
    plain, _ = plain_depth(batches[0][0], dev, P8)
    assert not any(counts().values()), "the plain path launched a kernel"
    assert np.array_equal(as_int(plain), maps[:8])


def test_wmajor_routes_match_legacy(dev):
    gl, gr = image.eyes_gray(torch.from_numpy(sbs_frames(8, SEED + 31)).to(
        dev), True)[:2]
    for pp in (P, P8):
        counts(reset=True)
        legacy = sgbm_disparity(gl, gr, pp)
        for route in ("xla", "mxu"):
            assert torch.equal(sgbm_disparity(gl, gr, pp,
                                              horizontal_route=route),
                               legacy), f"{route} at {pp.num_paths} paths"
        n8c = ran(("B8b", "B8c"), f"the routes at {pp.num_paths} paths")[1]
        assert n8c == 2, "not one B8c launch a route call"
    # B8c on the mxu route's padded volume (HP = 1152) equals HL = 1080
    cost = costvol.cost_volume(gl[:2], gr[:2], P, 2.0 * P.prefilter_cap)
    hl = wmajor.horizontal_sweeps_wmajor_kernel(
        cost.permute(0, 3, 2, 1).contiguous(), P.p1, P.p2, torch.int16)
    hp = wmajor.horizontal_sweeps_wmajor_kernel(
        wmajor.transpose_to_wmajor(cost), P.p1, P.p2, torch.int16)
    assert hp.shape[-1] == 1152 and torch.equal(hp[..., :H], hl)


def test_sgm_aggregate_pallas_public_entry(dev):
    """B8a through the package's public entry on the f32 and bf16 cost
    volume of two 1080p frames: one call, its launches the plan's."""
    gl, gr = image.eyes_gray(torch.from_numpy(sbs_frames(2, SEED + 40)).to(
        dev), True)[:2]
    cost = costvol.cost_volume(gl, gr, P, 2.0 * P.prefilter_cap)
    counts(reset=True)
    for dt, paths, n_call in (
            (torch.float32, 8, 3), (torch.bfloat16, 8, 3),
            (torch.float32, 5, 2), (torch.bfloat16, 5, 2),
            (torch.float32, 4, 3), (torch.float32, 2, 1)):
        before = sgm.aggregate_launches
        agg = kernels_api.sgm_aggregate_pallas(cost.to(dt), paths)
        assert agg.dtype == torch.float32 and agg.shape == cost.shape
        assert bool(torch.isfinite(agg).all())
        assert sgm.aggregate_launches == before + 1
        assert sgm.aggregate_plan[0] == n_call, (paths, sgm.aggregate_plan)
    ran(("B8a",), "sgm_aggregate_pallas")


def test_probe_run(dev):
    counts(reset=True)
    assert probe_i16.main([]) == 0, "the int16 probe failed"
    assert ran(("P",), "the probe") == [2], "not one launch a set of inputs"


@pytest.fixture(scope="module")
def crestereo_runs(tmp_path_factory):
    """``run(kev)``: the shipped default (no guidance argument; K = 4) or
    the same at ``guidance_every=1`` (the cell hybrid_k1_hsbs), the bundled
    weights, two batches of 8 to PNG16, every guide forward's batch
    recorded; each K run once and kept."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    runs = {}

    def run(kev):
        if kev in runs:
            return runs[kev]
        work = tmp_path_factory.mktemp(f"crestereo_k{kev}")
        opts = {} if kev == 4 else dict(guidance_every=kev)
        ext = StereoDepthExtractor(work_dir=str(work), batch_size=8, **opts)
        assert ext.guidance_every == kev
        ext.load_model()
        forwards = []
        hook = ext._guidance_fn.module.register_forward_hook(
            lambda mod, args, out: forwards.append(args[0].shape[0]))
        batches = [(sbs_frames(8, SEED + 60 + i), 8) for i in range(2)]
        try:
            n = run_stage(ext, batches, work / "depth_crestereo")
        finally:
            hook.remove()
        runs[kev] = dict(ext=ext, n=n, counts=counts(), forwards=forwards,
                         batches=batches, cache=work / "depth_crestereo",
                         work=work)
        return runs[kev]

    return run


@pytest.mark.parametrize("kev", [4, 1])
def test_crestereo_default_path(crestereo_runs, kev):
    from video3d_tpu_torch.models.crestereo import BUNDLED_WEIGHTS

    run = crestereo_runs(kev)
    ext, c = run["ext"], run["counts"]
    assert ext.guidance == "crestereo" and ext._guidance_fn is not None \
        and ext.model_checkpoint == str(BUNDLED_WEIGHTS), \
        f"the run degraded to {ext.guidance} from {ext.model_checkpoint}"
    assert run["n"] == 16
    # F1's fill and statistics, then F2, a batch
    assert [c[k] for k in ("B1", "B2", "B3", "B4", "B5", "B6", "B7",
                           "F")] == [2, 2, 2, 2, 0, 0, 0, 2 * 3], c
    assert run["forwards"] == [8 // kev] * 2, \
        f"not one forward of {8 // kev} keyframes a batch: {run['forwards']}"
    assert c["I1"] == 2, "I1 is not one launch a batch"
    maps = read_maps(run["cache"], run["n"])
    assert abs(median_px(maps) - 2 * SHIFT_EYE) <= 0.5
    cfn = ext._guidance_fn
    x0 = torch.from_numpy(run["batches"][0][0]).to("cuda")
    left, right = check_guided_batch(x0, cfn, maps[:8], kev)
    guide = cfn(left[::kev], right[::kev])
    assert guide.shape == (8 // kev, H, W_SBS) \
        and bool(torch.isfinite(guide).all())


def test_crestereo_bf16_matches_f32_on_cpu(crestereo_runs):
    """The bf16 model on the card against the f32 model on the CPU, one
    1080p keyframe pair (half-resolution inference)."""
    from video3d_tpu_torch.models.crestereo import load_crestereo_guidance

    run = crestereo_runs(4)
    cfn = run["ext"]._guidance_fn
    left, right = rgb_eyes(torch.from_numpy(run["batches"][0][0][:1]).to(
        "cuda"))
    cpu_fn = load_crestereo_guidance(dtype=torch.float32, device="cpu")
    d = (cfn(left, right).cpu() - cpu_fn(left.cpu(), right.cpu())).abs()
    assert float((d <= 0.5).float().mean().item()) >= 0.99
    assert float(d.median().item()) <= 0.1


@pytest.fixture(scope="module")
def published_runs(tmp_path_factory):
    """``run(kev)``: the hybrid with the published CREStereo at published
    widths (``--guidance crestereo --model <file>``) at K = ``kev``, two
    batches of 8 to PNG16, the network's passes recorded; kept per K."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    ckpt, guide, kind = published_checkpoint("cuda")
    runs = {}

    def run(kev):
        if kev in runs:
            return runs[kev]
        work = tmp_path_factory.mktemp(f"published_k{kev}")
        ext = StereoDepthExtractor(work_dir=str(work), batch_size=8,
                                   model_checkpoint=str(ckpt),
                                   guidance_every=kev)
        ext.load_model()
        assert ext._guidance_fn is not None, "the published file did not load"
        kind.check(ext._guidance_fn, guide)
        passes = []
        hook = ext._guidance_fn.module.register_forward_hook(
            lambda mod, args, out: passes.append(tuple(args[0].shape)))
        batches = [(sbs_frames(8, SEED + 80 + i), 8) for i in range(2)]
        try:
            n = run_stage(ext, batches, work / "depth")
        finally:
            hook.remove()
        runs[kev] = dict(ext=ext, n=n, counts=counts(), passes=passes,
                         batches=batches, cache=work / "depth", ckpt=ckpt,
                         guide=guide, kind=kind)
        return runs[kev]

    return run


@pytest.mark.parametrize("kev", [4, 1])
def test_crestereo_published_path(published_runs, kev):
    """One guidance call of 8 / K keyframes a batch, each call the two
    passes at 272x480 and 544x960; the stage's kernels, F1's fill and
    statistics and F2; every AGCL call one launch of A1 (40 of the first
    pass and 20 of the second a call), and span ``guide.agcl`` counts them
    ``fused``; then the fill, blend and twin checks of a guided batch."""
    from torch.profiler import ProfilerActivity, profile

    from video3d_tpu_torch.core import trace

    run = published_runs(kev)
    ext, c = run["ext"], run["counts"]
    assert ext.guidance == "crestereo" and run["n"] == 16
    assert [c[k] for k in ("B1", "B2", "B3", "B4", "B5", "B6", "B7",
                           "F")] == [2, 2, 2, 2, 0, 0, 0, 2 * 3], c
    k = 8 // kev
    assert run["passes"] == [(k, 3, 272, 480), (k, 3, 544, 960)] * 2, \
        run["passes"]
    calls = len(run["passes"]) // 2
    assert c["A1"] == 60 * 1 * calls, c  # 60 AGCL calls, a launch each
    gfn = ext._guidance_fn
    x0 = torch.from_numpy(run["batches"][0][0]).to("cuda")
    left, right = rgb_eyes(x0)
    trace.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            gfn(left[::kev], right[::kev])
        table = trace.summary()
    finally:
        trace.reset()
    assert table["guide.agcl"]["count"] == 60
    assert table["guide.agcl"]["counts"] == {"deformable": 20, "fused": 60}
    maps = read_maps(run["cache"], run["n"])
    assert abs(median_px(maps) - 2 * SHIFT_EYE) <= 0.5
    left, right = check_guided_batch(x0, gfn, maps[:8], kev)
    guide = gfn(left[::kev], right[::kev])
    assert guide.shape == (k, H, W_SBS) and bool(torch.isfinite(guide).all())


def test_crestereo_published_matches_f32_reference(published_runs):
    """One 1080p keyframe: the bf16 program on the card against the
    float32 reference (TF32 off) on the card. At the cell's shape, on a
    clip frame, bf16 moves the guide by ~0.04 px in the mean and ~0.15 at
    most, the fp8 control by ~0.4 and ~2.3; the bounds, 0.1 px in the
    mean and 1 px at most, lie between."""
    run = published_runs(4)
    gfn = run["ext"]._guidance_fn
    left, right = rgb_eyes(torch.from_numpy(run["batches"][0][0][:1]).to(
        "cuda"))
    net = run["kind"].reference(run["ckpt"], run["guide"], "cuda", False)
    want = net.guidance(left.double(), right.double(), "f64")
    err = (gfn(left, right).double() - want).abs()
    assert float(err.mean()) <= 0.1 and float(err.max()) <= 1.0, \
        (float(err.mean()), float(err.max()))


def test_upscale_ops_and_stage(crestereo_runs):
    """The CREStereo maps (a resident batch of 4) to 2160x3840, guided by
    the left eyes at 2x (nearest), uint16 out, each upsample against its
    CPU run; then ``DepthUpscaler`` on the maps and a synthetic 4K clip,
    once to PNG16 and once to mp4."""
    from video3d_tpu_torch.ops import guided
    from video3d_tpu_torch.stages.upscale import DepthUpscaler

    h4, w4 = 2 * H, 2 * W_SBS
    run = crestereo_runs(4)
    cache, work = run["cache"], run["work"]
    depth = torch.from_numpy(read_maps(cache, 16)[:4]).to("cuda")
    left, _ = rgb_eyes(torch.from_numpy(
        run["batches"][0][0][:4]).to("cuda"))
    g4k = left.round().clamp(0, 255).to(torch.uint8)
    g4k = g4k.repeat_interleave(2, 1).repeat_interleave(2, 2)
    ops = {
        "adaptive": lambda d, g: guided.adaptive_upsample(
            d, g, h4, w4, out_dtype="uint16"),
        "guided gray": lambda d, g: guided.guided_upsample(
            d, g, h4, w4, out_dtype="uint16"),
        "guided color": lambda d, g: guided.guided_upsample(
            d, g, h4, w4, guide_mode="color", out_dtype="uint16"),
        "plain": lambda d, g: guided.plain_upsample(
            d, h4, w4, out_dtype="uint16"),
    }
    counts(reset=True)
    for name, fn in ops.items():
        got = fn(depth, g4k).cpu().to(torch.int32)
        want = fn(depth.cpu(), g4k.cpu()).to(torch.int32)
        assert got.shape == (4, h4, w4), name
        d = (got - want).abs()
        assert int(d.max().item()) <= 2, name
        assert float((d <= 1).float().mean().item()) >= 0.999, name
    assert not any(counts().values()), f"the upscale launched {counts()}"
    clip = work / "guide_4k.mp4"
    with VideoWriter(str(clip), w4, h4, 24.0, preset="ultrafast") as vw:
        for f in torch.cat([g4k, g4k.flip(2)]).cpu().numpy():
            vw.write(f)
    up = DepthUpscaler(work_dir=str(work / "up"), batch_size=4,
                       preset="veryfast")
    out_png = up.process_depth_upscaling(str(cache), str(clip),
                                         png16_out=True)
    ups = [load_depth_png16(f) for f in list_depth_frames(out_png)]
    assert len(ups) == 16 and ups[0].shape == (h4, w4) \
        and ups[0].dtype == np.uint16
    assert out_png.name == f"depth_4k_{cache.name}_adaptive"
    out_mp4 = up.process_depth_upscaling(str(cache), str(clip), max_frames=8)
    assert out_mp4.is_file() and out_mp4.stat().st_size > 0
