"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the environment (torch, CUDA, nvcc, card name and power limit,
   TF32 flags, PNG writers available);
2. builds the port's CUDA kernels from ``video3d_tpu_torch/csrc`` (nvcc,
   sm_90a) and prints the build time;
3. holds each kernel against its plain PyTorch twin on the card at the
   main path's shapes: B1 cost volume (which is also B1-i16, the TPU's
   native-int16 variant), B2 horizontal sweeps, B3 vertical sweeps + WTA
   and B4 speckle at two 1080p frames, 1920-wide eyes, D=64, for MODE_SGBM
   (5 paths, int16 accumulator) and B2/B3 again for MODE_HH (8 paths, f32
   accumulator, bottom-up close), B1-B4 again at the stage's batch
   of 8 (rows ``...@8``), and B1-B4 at the small shapes of
   ``video3d_tpu_torch/tools/card_checks.py`` (ragged widths, short
   heights, D from 16 to 128, every SGM mode, 2 to 65 speckle bands;
   gated, not timed); B8a
   (``sgm_aggregate_pallas``, 8 and 5 paths, on B2's and B3's kernels:
   its launches a call from the recorded plan and a ``torch.profiler``
   trace, its time beside the floor of that structure; 2 and 4 paths
   gated and counted, not timed; and the small shapes of ``card_checks``)
   on f32 and bf16 cost, B8c (W-major sweeps: one direction forward and
   reverse, and both directions in one launch at the int16 and the f32
   accumulator, at HL = 1080 and HP = 1152), and the
   B8b round trip (equal to the input and to ``permute().contiguous()``)
   at the same shape, with its device time and the bytes a second it
   moves, and at the small shapes of ``card_checks`` in int16 and f32,
   twice, aligned and not; the six int16 probe ops (P) in one launch and
   each alone, at the probe's shape and at ragged ones; B5 flow warp at
   1080x1920 with r = 16 and at 270x480 with r = 6, B6 flow match at
   270x480; the fused forms the flow path runs: B6's level step (upsample,
   clamp, warp and match in one launch) at 270x480 from a 135x240 flow and
   B5's EMA step at 1080x1920 from a 270x480 guide with the depth gate on,
   each also along the small shapes of ``card_checks`` (level steps of
   whole pyramids, EMA steps at guides from 5x7 to 540x960) and run twice
   for the same bits; B7a/B7b attention at DPT-large's (2, 16, 577, 64) in bf16 and
   f32, at the K=1 hybrid's (8, 16, 577, 64) and at two other sequence
   lengths. B1, B2, B4, B8a, B8b, B8c and P
   must be bit-exact; B3 must have identical validity and disparity within
   1e-5 (margin within rtol 1e-6); B5 within 1e-5 (its EMA step within
   1e-4 on unit-scale depth), B6 within 2e-4 px (its level step too); B7
   within 1e-5 in f32 and, in bf16, within 2^-7 |twin| + 2^-10 (about one
   bf16 ulp) on >= 99.9% of the outputs. Each kernel's time (CUDA events)
   is printed beside its twin's, its bound (the larger of the bytes it
   must move over 3.35 TB/s and its operations over the unit's peak) and,
   where one PyTorch call computes the same function, that call's time
   (SDPA for B7, ``permute().contiguous()`` for B8b); for B7 and SDPA,
   B8b, P and B5's and B6's fused forms, also the device time per call
   from a ``torch.profiler`` trace, since their back-to-back event times
   include each call's host cost;
4. drives each path through the entry points a user calls, with every
   launch count set to 0 just before and read just after, and fails if a
   kernel of the path never ran: the stereo-only depth stage
   (``StereoDepthExtractor._run_batches``) over two batches of synthetic
   1920x1080 SBS frames whose eyes differ by a known horizontal shift,
   writing PNG16 maps (launch counts, valid fraction, median disparity,
   one batch's maps against the plain path); the same stage with the
   flow-guided temporal smoother over a panning clip (B1-B6, the
   pass-through of frame 0, the flow of the pan, batch 0 against the
   twins; B5's and B6's launches per smoothed frame); the DPT hybrid (DPT-large at full width and depth with random
   bf16 weights from seed 0, keyframes every 4th frame, hole fill, SSI
   alignment, confidence-trust blend; 24 B7 launches per batch, the fill,
   finite values, the median, batch 0 against the all-twin path); MODE_HH
   (``params=SGBMParams(num_paths=8)``) over two batches of 8 (median,
   valid fraction, batch 0 against the all-twin path); both W-major
   horizontal routes (``horizontal_route`` xla and mxu) on one batch of 8
   at 5 and 8 paths, bit-equal to the legacy route; B8a through the public
   ``sgm_aggregate_pallas`` at 8 and 5 paths on f32 and bf16 cost; the
   int16 probe's own run (two launches: one a set of inputs); the CREStereo
   hybrid, the shipped default (``StereoDepthExtractor`` with no guidance
   argument, the bundled weights; fails if it degrades to stereo-only;
   one forward of 2 keyframes and B1-B4 once per batch of 8, batch 0 step
   by step and against the twins, the median; the bf16 model on the card
   against the f32 model on the CPU on one 1080p pair); and the upscale
   (``adaptive_upsample``, ``guided_upsample`` gray and color and
   ``plain_upsample`` on a resident batch of 4 from 1080x1920 to
   2160x3840, each against its CPU run; ``DepthUpscaler`` on the CREStereo
   maps and a synthetic 4K clip, to PNG16 and to mp4);
5. times the stage's frames/s with and without the flow smoother, with
   DPT guidance at K=4 and K=1, in MODE_HH and on each route, the DPT-large
   forward per keyframe, the CREStereo hybrid at K=4 and K=1, one
   CREStereo keyframe's forward beside its FLOP bound, each upsample per
   4K frame (median and spread over repeats), and the smoother alone per
   frame, with its device operations per frame counted in a
   ``torch.profiler`` trace.

The second-to-last line is a JSON object of the kernels, preceded by the
card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. There is no CPU mode.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
B, H, W_SBS, D = 2, 1080, 1920, 64
SHIFT_EYE = 8  # eye pixels; 16 px disparity after the 2x unsqueeze
PAN_EYE = 2  # eye pixels per frame of the panning clip: 1 px at the 1/4 guide
SEED = 0
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
# peak operations/s by unit: f32 (and int32) on the CUDA cores, bf16 on
# the tensor cores (dense), from the H100 SXM data sheet at 700 W
PEAK_OPS_S = {"f32": 67e12, "bf16": 989e12}
SWEEP_OPS = 9  # per element and direction: 4 min, 4 add/sub, 1 acc add
WTA_OPS = 8  # per element: the two minima, the right-image min, compares
# B4 per pixel, counted with running sums whatever implements it: the band
# (subtract, divide, floor, two clamps), then per cumulative band plane (3 at
# the defaults) one add and one subtract each for the horizontal and the
# vertical window, the difference of two planes and the compare
SPECKLE_OPS = 5 + 3 * 4 + 2
# B6's level step per pixel, counted whatever implements it: the incoming
# flow's upsample (2 x 7) and clamp (2 x 2); the warp (2 passes: floor, two
# hats of 3, two products and a sum); per candidate (25) the difference,
# its magnitude, a running add and subtract each way and the area scale,
# then the minimum, the exponent's difference and scale, the exp and three
# products-and-sums of the softargmin; the radius-2 smoothing of the two
# residuals (running sums, 4 each), its division and the add
LEVEL_OPS = 2 * 7 + 2 * 2 + 2 * 10 + 25 * (7 + 1 + 3 + 6) + 2 * (4 + 2)
# B5's EMA step per full-resolution pixel: three upsamples (flow y, x and
# alpha, 7 each), the warp (20), |depth - warp| (2), the radius-2 box
# (running sums, 4) and its division, the gate (6) and the blend (4); per
# guide pixel: the warp (20), |g - warp| (2), the box (4) and its
# division, alpha (4)
EMA_OPS = 3 * 7 + 20 + 2 + 4 + 1 + 6 + 4
GUIDE_OPS = 20 + 2 + 4 + 1 + 4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def pan_frames(n: int, seed: int) -> np.ndarray:
    """(n, 1080, 1920, 3) uint8 SBS frames of one random texture (2-pixel
    grain) panning PAN_EYE eye pixels per frame: frame t's left eye is
    base[:, PAN_EYE*t:], so cur(x) = prev(x + PAN_EYE) (backward flow
    +PAN_EYE). The right eye is the left shifted by SHIFT_EYE, as in
    ``tools/time_kernels.py sbs_batch``, which makes the still frames."""
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


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls."""
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_times(fn, reps: int) -> list:
    """Device milliseconds of each of ``reps`` calls of ``fn`` (CUDA events
    around each call, synchronised), after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        times.append(timed(fn)[1])
    return times


def profile_kernels(fn, reps: int):
    """(device operations per call, {kernel name: (launches per call,
    device ms per call)}) from a ``torch.profiler`` trace of ``reps`` calls
    of ``fn`` after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = per.get(e.name, (0, 0.0))
            per[e.name] = (n + 1, us + e.time_range.elapsed_us())
    n_dev = sum(n for n, _ in per.values())
    return n_dev / reps, {k: (n / reps, us / 1e3 / reps)
                          for k, (n, us) in per.items()}


def print_top(per: dict, top: int = 8) -> None:
    """The ``top`` kernels of :func:`profile_kernels` by device time."""
    for name, (n, ms) in sorted(per.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {ms:8.4f} ms  {n:5.1f} x  {name[:100]}")


def spread(times) -> str:
    """'median (min-max)' of a list of milliseconds."""
    return (f"{float(np.median(times)):.3f} ms (spread "
            f"{min(times):.3f}-{max(times):.3f}, {len(times)} runs)")


def device_ms(fn, reps: int):
    """Mean device milliseconds per call of ``fn``: the kernels' summed
    time in a ``torch.profiler`` trace of ``reps`` calls, or None when the
    trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages())
    return total_us / 1e3 / reps if total_us > 0 else None


def launch_ms(fn, reps: int, word: str):
    """Device milliseconds per call of ``fn`` in the kernels whose name
    holds ``word``, each launched once a call: the sum over those kernels
    of their mean time a record in a ``torch.profiler`` trace (a trace
    has been seen to drop a record), or None when it holds none."""
    _, per = profile_kernels(fn, reps)
    got = [ms / n for name, (n, ms) in per.items() if word in name and n]
    return sum(got) if got else None


def timed(fn):
    """(result, device milliseconds) of one call of ``fn``."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes: float, ops: float = 0.0, unit: str = "f32"):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` (each input read once, each output written once) and
    do ``ops`` operations on ``unit``."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[unit] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def twins():
    """Swap the wrappers of B1-B4 and B7 for their plain twins, so the
    stage's own code runs on the card with no CUDA kernel of the port."""
    from video3d_tpu_torch.kernels import attention, costvol, sgm, speckle
    from video3d_tpu_torch.ops.attention import attention_plain
    from video3d_tpu_torch.ops.speckle import speckle_filter_device

    swaps = (
        (costvol, "cost_volume", costvol.cost_volume_plain),
        (sgm, "horizontal_sweeps", sgm.horizontal_sweeps_plain),
        (sgm, "vertical_sweeps_wta", sgm.vertical_sweeps_wta_plain),
        (speckle, "speckle_filter", speckle_filter_device),
        (attention, "attention_multihead",
         lambda q, k, v, sm_scale, heads_per_step=8:
         attention_plain(q, k, v, sm_scale)),
    )
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    t_start = time.perf_counter()

    def phase(name: str) -> None:
        print(f"-- {name} (at {time.perf_counter() - t_start:.1f} s)",
              flush=True)
    sys.path.insert(0, str(ROOT))
    from video3d_tpu_torch.core import (_native, list_depth_frames,
                                        load_depth_png16)
    import video3d_tpu_torch.kernels as kernels_api
    from video3d_tpu_torch.kernels import (_build, attention, costvol,
                                           flowmatch, sgm, speckle, warp,
                                           wmajor)
    from video3d_tpu_torch.core import VideoWriter
    from video3d_tpu_torch.models.crestereo import (BUNDLED_WEIGHTS,
                                                    conv_flops,
                                                    load_crestereo_guidance)
    from video3d_tpu_torch.models.dpt import random_dpt_guidance
    from video3d_tpu_torch.ops import guided
    from video3d_tpu_torch.ops.attention import attention_plain
    from video3d_tpu_torch.ops.fill import fill_holes
    from video3d_tpu_torch.ops.flow import (FlowEMAParams, ema_tail_plain,
                                            estimate_flow_fast,
                                            flow_ema_scan, flow_level_plain,
                                            flow_match_plain,
                                            warp_bilinear_shifts_plain)
    from video3d_tpu_torch.ops.flow import shift_edge as flow_shift
    from video3d_tpu_torch.ops.image import resize2d, rgb_to_gray
    from video3d_tpu_torch.ops.speckle import speckle_filter_device
    from video3d_tpu_torch.ops.stereo import (INVALID, SGBMParams,
                                              acc_dtype_for_params,
                                              sgbm_disparity, sgm_aggregate)
    from video3d_tpu_torch.parallel.temporal import TemporalFlowEMAStream
    from video3d_tpu_torch.stages.depth import (StereoDepthExtractor,
                                                depth_batch_pipeline,
                                                disparity_to_uint16,
                                                gray_pair, guidance_blend,
                                                rgb_eyes)
    from video3d_tpu_torch.stages.upscale import DepthUpscaler
    from video3d_tpu_torch.tools import card_checks, probe_i16
    from video3d_tpu_torch.tools.time_kernels import sbs_batch

    def sbs_frames(n: int, seed: int) -> np.ndarray:
        """(n, 1080, 1920, 3) uint8 SBS frames, the eyes SHIFT_EYE apart,
        as the profiler makes them."""
        return sbs_batch(n, seed, H, W_SBS // 2, SHIFT_EYE)

    # f32 matmuls (resizes, the twins) stay full f32; the only convs are
    # DPT's, whose f32 ones run at TF32, PyTorch's default (models/dpt.py)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # -- 1. environment ----------------------------------------------------
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    print(f"nvcc: {nvcc}")
    print(f"card: {card}")
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    try:
        import cv2
        cv2_version = cv2.__version__
    except ImportError:
        cv2_version = None
    print(f"cv2: {cv2_version}; native PNG writer: "
          f"{'yes' if _native.lib() is not None else 'no'}")

    # -- 2. build ----------------------------------------------------------
    phase("2. build")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.1f} s) "
          f"-> {lib_path.relative_to(ROOT)}")

    # -- 3. each kernel against its twin at the main path's shapes ---------
    phase("3. kernels against their twins")
    p = SGBMParams()
    p8 = SGBMParams(num_paths=8)
    inv = 2.0 * p.prefilter_cap
    frames2 = torch.from_numpy(sbs_frames(B, SEED)).to(dev)
    gl, gr = gray_pair(frames2)
    check(gl.shape == (B, H, W_SBS), f"gray shape {tuple(gl.shape)}")
    rows = {}  # key -> row of the kernels line
    vol = B * H * W_SBS * D  # elements of the batch's cost volume
    pix = B * H * W_SBS

    def add_row(key, **row):
        t, by = bound(*row["work"])
        rows[key] = dict(row, bound_ms=t, bound_by=by,
                         library_ms=row.get("library_ms"))

    cost, lf = costvol.cost_volume(gl, gr, p, inv, return_filtered_left=True)
    check(cost.shape == (B, H, W_SBS, D), f"cost shape {tuple(cost.shape)}")
    cost_p, lf_p = costvol.cost_volume_plain(gl, gr, p, inv, True)
    torch.cuda.synchronize()
    err = (cost.int() - cost_p.int()).abs().max().item()
    check(err == 0 and torch.equal(lf, lf_p), f"B1 differs from twin: {err}")
    at_1080 = "ms/frame at 1080p D=64"
    b1 = dict(
        at=at_1080, source="video3d_tpu_torch/csrc/costvol.cu", max_abs_err=err,
        ms=cuda_ms(lambda: costvol.cost_volume(gl, gr, p, inv), 5) / B,
        plain_ms=cuda_ms(lambda: costvol.cost_volume_plain(gl, gr, p, inv),
                         1) / B,
        # two f32 eyes in, int16 volume out; BT cost and separable box sums
        work=((2 * pix * 4 + vol * 2) / B, 20 * vol / B))
    add_row("B1", name="B1 cost_volume",
            replaces="video3d_tpu/kernels/costvol.py:394", **b1)
    # the TPU's native-int16 variant computes the same function bit for bit
    # (tests/test_torch_sgm_paths.py), as costvol.cu does: the same kernel
    add_row("B1-i16", name="B1-i16 cost_volume (native int16 at 2x scale)",
            replaces="video3d_tpu/kernels/costvol.py:196", **b1)
    del cost_p, lf_p

    for key, pp in (("B2", p), ("B2-hh", p8)):
        acc = sgm.horizontal_sweeps(cost, pp)
        acc_p = sgm.horizontal_sweeps_plain(cost, pp)
        torch.cuda.synchronize()
        err = (acc.double() - acc_p.double()).abs().max().item()
        check(err == 0, f"{key} differs from twin: {err}")
        ab = acc.element_size()
        add_row(key, at=at_1080,
                name=("B2 horizontal_sweeps" if pp is p else
                      "B2 horizontal_sweeps, f32 acc (MODE_HH)"),
                source="video3d_tpu_torch/csrc/sgm.cu",
                replaces="video3d_tpu/kernels/sgm.py:617", max_abs_err=err,
                ms=cuda_ms(lambda: sgm.horizontal_sweeps(cost, pp), 5) / B,
                plain_ms=cuda_ms(lambda: sgm.horizontal_sweeps_plain(
                    cost, pp), 1) / B,
                work=(vol * (2 + ab) / B, 2 * SWEEP_OPS * vol / B))
        del acc_p
        hp = sgm.horizontal_plan
        print(f"{key} is one launch for both directions: {hp[2]} blocks of 4 "
              f"warps, {hp[0]} resident on each of {hp[1]} multiprocessors, "
              f"a warp taking {hp[3]} group(s) of rows in turn (batch of "
              f"{B})")
        if pp is p:
            acc5 = acc
    acc8 = acc

    for key, pp, acc in (("B3", p, acc5), ("B3-hh", p8, acc8)):
        disp_p, m_p = sgm.vertical_sweeps_wta_plain(cost, acc, pp, True)
        acc_scratch = acc.clone()
        disp, m = sgm.vertical_sweeps_wta(cost, acc_scratch, pp, True)
        torch.cuda.synchronize()
        err = (disp - disp_p).abs().max().item()
        check(torch.equal(disp >= 0, disp_p >= 0), f"{key} validity differs")
        check(err <= 1e-5, f"{key} disparity differs from twin: {err}")
        check(torch.allclose(m, m_p, rtol=1e-6, atol=0.0),
              f"{key} margin differs")
        n_dirs = 3 if pp is p else 6
        add_row(key, at=at_1080,
                name=("B3 vertical_sweeps_wta (MODE_SGBM, top-down)"
                      if pp is p else "B3 vertical_sweeps_wta, f32 acc "
                      "(MODE_HH, top-down then bottom-up)"),
                source="video3d_tpu_torch/csrc/sgm.cu",
                replaces="video3d_tpu/kernels/sgm.py:882", max_abs_err=err,
                # the kernel adds into its acc argument: time it on a
                # scratch copy (wrap-around in the scratch does not change
                # the work done)
                ms=cuda_ms(lambda: sgm.vertical_sweeps_wta(
                    cost, acc_scratch, pp), 5) / B,
                plain_ms=cuda_ms(lambda: sgm.vertical_sweeps_wta_plain(
                    cost, acc, pp), 1) / B,
                work=((vol * (2 + acc.element_size()) + pix * 4) / B,
                      (n_dirs * SWEEP_OPS + WTA_OPS) * vol / B))
        if pp is p:
            disp5 = disp
        del disp_p, m_p, m, acc_scratch
    disp = disp5
    del acc5, acc8, acc

    sp_args = (INVALID(p), float(p.speckle_range), p.speckle_window_size,
               (0.0, float(p.num_disparities)))
    sp = speckle.speckle_filter(disp, *sp_args)
    sp_p = speckle_filter_device(disp, *sp_args)
    torch.cuda.synchronize()
    err = (sp - sp_p).abs().max().item()
    check(torch.equal(sp, sp_p), f"B4 differs from twin: {err}")
    add_row("B4", at=at_1080, name="B4 speckle_filter",
            source="video3d_tpu_torch/csrc/speckle.cu",
            replaces="video3d_tpu/kernels/speckle.py:159", max_abs_err=err,
            ms=cuda_ms(lambda: speckle.speckle_filter(disp, *sp_args), 10) / B,
            plain_ms=cuda_ms(lambda: speckle_filter_device(disp, *sp_args),
                             3) / B,
            # the f32 map read once and written once
            work=(2 * pix * 4 / B, SPECKLE_OPS * pix / B))
    del disp, sp, sp_p, frames2
    print(f"B3's 3-direction launches are cooperative: "
          f"{sgm.vertical_plan[0]} blocks of {sgm.vertical_plan[5]} columns "
          f"on each of {sgm.vertical_plan[1]} multiprocessors, "
          f"{sgm.vertical_plan[2]} strips a frame, so {sgm.vertical_plan[3]} "
          f"frames a launch ({sgm.vertical_plan[4]} launch for the batch of "
          f"{B})")

    # B1-B4 again at the stage's batch of 8, where four times the frames
    # are resident, so fewer steps of the sweeps' chains wait for a load
    # (the sweeps are then bound by the integer operations of a step and,
    # B2, by its bytes); each gated against its twin there too
    batch8 = 8
    gl8, gr8 = gray_pair(
        torch.from_numpy(sbs_frames(batch8, SEED + 50)).to(dev))
    at_8 = "ms/frame at 1080p D=64, batch 8"
    cost8 = costvol.cost_volume(gl8, gr8, p, inv)
    cost8_p, plain_ms = timed(lambda: costvol.cost_volume_plain(gl8, gr8, p,
                                                                inv))
    err = (cost8.int() - cost8_p.int()).abs().max().item()
    check(err == 0, f"B1 at batch 8 differs from twin: {err}")
    del cost8_p
    add_row("B1@8", at=at_8, name="B1 cost_volume, batch 8",
            source=b1["source"],
            replaces="video3d_tpu/kernels/costvol.py:394", max_abs_err=err,
            ms=cuda_ms(lambda: costvol.cost_volume(gl8, gr8, p, inv),
                       5) / batch8,
            plain_ms=plain_ms / batch8, work=b1["work"])
    del gl8, gr8
    for tag, pp in (("", p), ("-hh", p8)):
        acc = sgm.horizontal_sweeps(cost8, pp)
        if pp is p:
            acc_p, plain_ms = timed(lambda: sgm.horizontal_sweeps_plain(
                cost8, pp))
            err = (acc.double() - acc_p.double()).abs().max().item()
            check(err == 0, f"B2 at batch 8 differs from twin: {err}")
            del acc_p
            add_row("B2@8", at=at_8, name="B2 horizontal_sweeps, batch 8",
                    source="video3d_tpu_torch/csrc/sgm.cu",
                    replaces="video3d_tpu/kernels/sgm.py:617",
                    max_abs_err=err, plain_ms=plain_ms / batch8,
                    ms=cuda_ms(lambda: sgm.horizontal_sweeps(cost8, pp),
                               5) / batch8,
                    work=rows["B2"]["work"])
            hp = sgm.horizontal_plan
            print(f"B2 at batch 8: {hp[2]} blocks of 4 warps, {hp[0]} "
                  f"resident on each of {hp[1]} multiprocessors, a warp "
                  f"taking {hp[3]} group(s) of rows in turn")
        (disp_p, m_p), plain_ms = timed(
            lambda: sgm.vertical_sweeps_wta_plain(cost8, acc, pp, True))
        acc_scratch = acc.clone()
        disp8, m8 = sgm.vertical_sweeps_wta(cost8, acc_scratch, pp, True)
        torch.cuda.synchronize()
        err = (disp8 - disp_p).abs().max().item()
        check(torch.equal(disp8 >= 0, disp_p >= 0),
              f"B3{tag} at batch 8: validity differs")
        check(err <= 1e-5, f"B3{tag} at batch 8 differs from twin: {err}")
        check(torch.allclose(m8, m_p, rtol=1e-6, atol=0.0),
              f"B3{tag} at batch 8: margin differs")
        if pp is p:
            sp8 = speckle.speckle_filter(disp8, *sp_args)
            sp8_p, plain_ms4 = timed(lambda: speckle_filter_device(
                disp8, *sp_args))
            check(torch.equal(sp8, sp8_p), "B4 at batch 8 differs from twin")
            add_row("B4@8", at=at_8, name="B4 speckle_filter, batch 8",
                    source="video3d_tpu_torch/csrc/speckle.cu",
                    replaces="video3d_tpu/kernels/speckle.py:159",
                    max_abs_err=(sp8 - sp8_p).abs().max().item(),
                    plain_ms=plain_ms4 / batch8,
                    ms=cuda_ms(lambda: speckle.speckle_filter(
                        disp8, *sp_args), 10) / batch8,
                    work=rows["B4"]["work"])
            del sp8, sp8_p
        del disp_p, m_p, disp8, m8
        add_row(f"B3{tag}@8", at=at_8,
                name=rows[f"B3{tag}"]["name"] + ", batch 8",
                source="video3d_tpu_torch/csrc/sgm.cu",
                replaces="video3d_tpu/kernels/sgm.py:882", max_abs_err=err,
                plain_ms=plain_ms / batch8,
                ms=cuda_ms(lambda: sgm.vertical_sweeps_wta(
                    cost8, acc_scratch, pp), 5) / batch8,
                work=rows[f"B3{tag}"]["work"])
        print(f"B3{tag} at batch 8: {sgm.vertical_plan[3]} frames a launch, "
              f"{sgm.vertical_plan[4]} launches per sweep step")
        del acc, acc_scratch
    del cost8
    torch.cuda.empty_cache()

    # B1-B4 at small shapes that the 1080p run does not stress
    for case in card_checks.B1_CASES:
        card_checks.check_b1(dev, *case)
    for case in card_checks.B2_CASES:
        card_checks.check_b2(dev, *case)
    for case in card_checks.B3_CASES:
        card_checks.check_b3(dev, *case)
    for case in card_checks.B4_CASES:
        card_checks.check_b4(dev, *case)
    for case in card_checks.B8C_CASES:
        card_checks.check_b8c(dev, *case)
    for case in card_checks.B8A_CASES:
        card_checks.check_b8a(dev, *case)
    for case in card_checks.B8B_CASES:
        for types in ("i16", "f32"):
            card_checks.check_b8b(dev, *case, types)
    for case in card_checks.P_CASES:
        card_checks.check_p(dev, case)
    print(f"B1 equals its twin at {len(card_checks.B1_CASES)} small shapes "
          f"(D 16-128, widths 33-1000, heights 2-137, min_disparity 0 and "
          f"3, blocks 3-9); B2 at {len(card_checks.B2_CASES)} (widths "
          f"1-1000, int16 and f32 accumulator); B3 holds its gates at "
          f"{len(card_checks.B3_CASES)} (2, 4, 5 and 8 paths, with and "
          f"without the margin); B4 equals its twin at "
          f"{len(card_checks.B4_CASES)} (2 to 65 bands, min_region 1-400, "
          f"maps smaller than the window); B8c at "
          f"{len(card_checks.B8C_CASES)} (both entries, D 16-128, rows "
          f"1-1152, widths 1-257, all three type pairs, twice each); B8a at "
          f"{len(card_checks.B8A_CASES)} (2, 4, 5 and 8 paths, f32 and bf16 "
          f"non-integer costs, D 1-128, widths 1-257, heights 1-137, one and "
          f"two chunks of frames, twice each); B8b at "
          f"{len(card_checks.B8B_CASES)} in int16 and f32 (heights 1-130, "
          f"widths 1-257, D 1-128, each to and from twice, aligned and "
          f"not); P at {len(card_checks.P_CASES)} ragged shapes (all six "
          f"ops in one launch and each alone, aligned and not)")

    # B8a, the public sgm_aggregate_pallas, at 8 and 5 paths on the f32 and
    # bf16 cost (the B1 volume over 3: non-integer values, the default
    # penalties over 3); bit-equal to its twin. Its launches a call are the
    # recorded plan's and the device kernels of a torch.profiler trace. The
    # floor of its structure: the horizontal launch moves the cost twice and
    # the f32 accumulator three times, each vertical launch the cost and
    # the accumulator once and the total once
    def b8a_kernels(cf, paths, pa):
        """({sweep kernel: (launches a call, ms a call)}, kernels a call)
        of B8a in a torch.profiler trace. A trace has been seen to hold one
        kernel record fewer than the calls launched, so the count a call
        is taken over five calls and rounded."""
        _, per = profile_kernels(lambda: sgm.sgm_aggregate_pallas(
            cf, paths, pa.p1, pa.p2), 5)
        sweeps = {name: v for name, v in per.items()
                  if "horizontal_kernel" in name or "vertical_kernel" in name}
        return sweeps, sum(n for n, _ in sweeps.values())

    for paths in (8, 5):
        pa = SGBMParams(num_paths=paths, p1=p.p1 / 3, p2=p.p2 / 3)
        steps = 2 if paths == 8 else 1
        for dt, short in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            key = f"B8a-{short}" + ("-5" if paths == 5 else "")
            cf = (cost.to(torch.float32) / 3).to(dt)
            got = sgm.sgm_aggregate_pallas(cf, paths, pa.p1, pa.p2)
            want = sgm_aggregate(cf, pa)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(torch.equal(got, want), f"{key} differs from twin: {err}")
            del got, want
            n_call = sgm.aggregate_plan[0]
            check(n_call == 1 + steps,
                  f"{key}: {n_call} launches a call, not {1 + steps}")
            sweeps, n_dev = b8a_kernels(cf, paths, pa)
            check(round(n_dev) == n_call, f"{key}: {n_dev} kernels a call "
                  f"in the profile, the plan says {n_call}")
            cb = cf.element_size()
            floor_b = ((2 * cb + 3 * 4) + steps * (cb + 2 * 4)) * vol / B
            add_row(key, at=at_1080,
                    name=f"B8a sgm_aggregate_pallas, {paths} paths, "
                         f"{str(dt)[6:]} cost",
                    source="video3d_tpu_torch/csrc/sgm.cu",
                    replaces="video3d_tpu/kernels/sgm.py:119",
                    max_abs_err=err,
                    ms=cuda_ms(lambda: sgm.sgm_aggregate_pallas(
                        cf, paths, pa.p1, pa.p2), 5) / B,
                    plain_ms=cuda_ms(lambda: sgm_aggregate(cf, pa), 1) / B,
                    # the cost read once, the f32 total written once
                    work=(vol * (cb + 4) / B, paths * SWEEP_OPS * vol / B))
            r = rows[key]
            print(f"{key}: {n_call} launches a call (torch.profiler: "
                  f"{n_dev} kernels, device "
                  f"{sum(ms for _, ms in sweeps.values()) / B:.4f} ms/frame); "
                  f"{r['ms']:.4f} ms/frame against the floor of its "
                  f"structure {floor_b / HBM_BYTES_S * 1e3:.4f} "
                  f"({floor_b / 1e6:.0f} MB a frame) and the bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}) on {card}")
            for name, (n, ms) in sorted(sweeps.items()):
                print(f"  {ms / B:8.4f} ms/frame  {n:4.1f} a call  "
                      f"{name[:90]}")
            del cf
    hp, vp = sgm.horizontal_plan, sgm.vertical_plan
    # the other two modes: bit-equal to the twin, 1 and 3 launches a call
    cf = cost.to(torch.float32) / 3
    for paths, launches in ((2, 1), (4, 3)):
        pa = SGBMParams(num_paths=paths, p1=p.p1 / 3, p2=p.p2 / 3)
        check(torch.equal(sgm.sgm_aggregate_pallas(cf, paths, pa.p1, pa.p2),
                          sgm_aggregate(cf, pa)),
              f"B8a at {paths} paths differs from twin")
        _, n_dev = b8a_kernels(cf, paths, pa)
        check(round(n_dev) == sgm.aggregate_plan[0] == launches,
              f"B8a at {paths} paths: {n_dev} kernels a call in the "
              f"profile, the plan says {sgm.aggregate_plan[0]}")
        print(f"B8a at {paths} paths, f32 cost: equal to its twin, "
              f"{launches} launch(es) a call (torch.profiler: {n_dev:.1f} "
              f"kernels)")
    del cf
    print(f"B8a's launches (bf16, 5 paths): horizontal {hp[2]} blocks, "
          f"{hp[0]} resident on each of {hp[1]} multiprocessors; vertical "
          f"{vp[0]} blocks of {vp[5]} columns a multiprocessor, {vp[2]} "
          f"strips a frame, {vp[3]} frames a launch")

    # B8c on the W-major volume. The one-direction entry, forward into a
    # fresh accumulator and reverse added in place, against its twin; the
    # two-direction entry (one launch, as the routes call it) at the int16
    # (5 paths) and the f32 (8 paths) accumulator against its twin, twice
    # for the same bits, and against B2's sums; at HL = 1080 (route xla)
    # and HP = 1152 (route mxu)
    cost_t = cost.permute(0, 3, 2, 1).contiguous()  # (B, D, W, H)
    fwd = wmajor.wmajor_sweep(cost_t, None, p.p1, p.p2, False, torch.int16)
    fwd_p = wmajor.wmajor_sweep_plain(cost_t, None, p.p1, p.p2, False,
                                      torch.int16)
    rev = wmajor.wmajor_sweep(cost_t, fwd.clone(), p.p1, p.p2, True)
    rev_p = wmajor.wmajor_sweep_plain(cost_t, fwd_p, p.p1, p.p2, True)
    torch.cuda.synchronize()
    err1 = max((fwd.int() - fwd_p.int()).abs().max().item(),
               (rev.int() - rev_p.int()).abs().max().item())
    check(err1 == 0, f"B8c one direction differs from twin: {err1}")
    del fwd, fwd_p, rev
    for key, pp in (("B8c", p), ("B8c-f32", p8)):
        adt = acc_dtype_for_params(torch.int16, pp)
        both = wmajor.horizontal_sweeps_wmajor_kernel(cost_t, pp.p1, pp.p2,
                                                      adt)
        again = wmajor.horizontal_sweeps_wmajor_kernel(cost_t, pp.p1, pp.p2,
                                                       adt)
        both_p, plain_ms = timed(lambda: wmajor.horizontal_sweeps_wmajor_plain(
            cost_t, pp.p1, pp.p2, adt))
        torch.cuda.synchronize()
        err = max(err1, (both.double() - both_p.double()).abs().max().item())
        check(err == 0, f"{key} differs from twin: {err}")
        check(torch.equal(both, again), f"{key}: two runs differ")
        check(both.dtype == adt and (pp is p8 or torch.equal(both, rev_p)),
              f"{key}: two directions differ from two one-direction sweeps")
        check(torch.equal(both.permute(0, 3, 2, 1),
                          sgm.horizontal_sweeps(cost, pp)),
              f"{key}: sums differ from B2's")
        del both_p, again
        hp = wmajor.horizontal_plan
        print(f"{key}: one launch, {hp[2]} blocks of 256 threads, {hp[0]} "
              f"resident on each of {hp[1]} multiprocessors, {hp[3]} "
              f"round(s) of {hp[4]}-row tiles, {hp[5]} shared bytes a block")
        if pp is p:  # HP = 1152, the mxu route's padded volume
            cost_hp = wmajor.transpose_to_wmajor(cost)
            got_hp = wmajor.horizontal_sweeps_wmajor_kernel(cost_hp, pp.p1,
                                                            pp.p2, adt)
            check(torch.equal(got_hp[..., :H], both),
                  f"{key} at HP = 1152 differs from HL = 1080")
            check(torch.equal(got_hp, wmajor.horizontal_sweeps_wmajor_plain(
                cost_hp, pp.p1, pp.p2, adt)),
                f"{key} at HP = 1152 differs from twin")
            del cost_hp, got_hp
        del both
        add_row(key, at=at_1080 + ", both directions in one launch",
                name=f"B8c horizontal_sweeps_wmajor_kernel (W-major "
                     f"horizontals), {str(adt)[6:]} acc",
                source="video3d_tpu_torch/csrc/wmajor.cu",
                replaces="video3d_tpu/kernels/sgm.py:391", max_abs_err=err,
                ms=cuda_ms(lambda: wmajor.horizontal_sweeps_wmajor_kernel(
                    cost_t, pp.p1, pp.p2, adt), 5) / B,
                plain_ms=plain_ms / B,
                # the int16 cost read once, the total written once, as
                # B2's row counts the same function
                work=(vol * (2 + torch.tensor([], dtype=adt).element_size())
                      / B, 2 * SWEEP_OPS * vol / B))
    del cost_t, rev_p
    torch.cuda.empty_cache()

    # B8b round trip: equal to the input and to permute().contiguous()
    t = wmajor.transpose_to_wmajor(cost)
    back = wmajor.transpose_from_wmajor(t, H)
    t_p = wmajor.transpose_to_wmajor_plain(cost)
    torch.cuda.synchronize()
    check(torch.equal(back, cost), "B8b round trip differs from its input")
    check(torch.equal(t, t_p), "B8b differs from its twin")
    check(torch.equal(t[..., :H], cost.permute(0, 3, 2, 1)),
          "B8b differs from permute")
    del back, t_p

    def lib_round_trip():
        cost.permute(0, 3, 2, 1).contiguous()[..., :H].permute(
            0, 3, 2, 1).contiguous()

    def b8b_round_trip():
        wmajor.transpose_from_wmajor(wmajor.transpose_to_wmajor(cost), H)

    add_row("B8b", at=at_1080 + ", to and from W-major (HP = 1152)",
            name="B8b transpose_to/from_wmajor",
            source="video3d_tpu_torch/csrc/wmajor.cu",
            replaces="video3d_tpu/kernels/sgm.py:254,279", max_abs_err=0,
            ms=cuda_ms(b8b_round_trip, 10) / B,
            plain_ms=cuda_ms(lambda: wmajor.transpose_from_wmajor_plain(
                wmajor.transpose_to_wmajor_plain(cost), H), 3) / B,
            library_ms=cuda_ms(lib_round_trip, 5) / B,
            # each way the int16 volume read once and written once; the
            # padding lanes are garbage by contract and not counted
            work=(4 * vol * 2 / B,))
    r = rows["B8b"]
    dev_b8b = launch_ms(b8b_round_trip, 10, "transpose_kernel")
    tp = wmajor.transpose_plan
    print(f"B8b: {r['ms']:.4f} ms/frame to + from (CUDA events), device "
          + (f"{dev_b8b / B:.4f}" if dev_b8b else "not measured")
          + f" (torch.profiler), {4 * vol * 2 / B / r['ms'] / 1e9:.3f} TB/s "
          f"of the bound's bytes; bound {r['bound_ms']:.4f}; one launch a "
          f"way, {tp[2]} blocks ({tp[0]} on each of {tp[1]} "
          f"multiprocessors) walking {tp[3]} tiles on {card}")
    del t, cost
    torch.cuda.empty_cache()

    # P: the six int16 probe ops at the probe's shape in one launch, each
    # against its torch expression on the probe's inputs and on full-range
    # ones (add wraps, the cast saturates), and each op alone (its bit of
    # the mask); timed on the probe's
    xs_full = probe_i16.probe_inputs(dev, full_range=True)
    xs = probe_i16.probe_inputs(dev)
    for ins in (xs, xs_full):
        n = probe_i16.launches
        got = probe_i16.probe_all(*ins)
        check(probe_i16.launches == n + 1, "P: probe_all is not one launch")
        for k, (name, (_, n_in, expr)) in enumerate(probe_i16.OPS.items()):
            want = expr(*ins[:n_in])
            torch.cuda.synchronize()
            check(torch.equal(got[k], want), f"P {name} differs from torch")
            check(torch.equal(probe_i16.probe_op(name, *ins[:n_in]), want),
                  f"P {name} alone differs from torch")
    n_el = xs[0].numel()
    add_row("P", at="ms for all six ops at (8, 64, 256) int16, one call",
            name="P probe_i16 (six int16 toy ops, one launch)",
            source="video3d_tpu_torch/csrc/probe_i16.cu",
            replaces="tools/probe_i16.py:34", max_abs_err=0,
            ms=cuda_ms(lambda: probe_i16.probe_all(*xs), 100),
            plain_ms=cuda_ms(lambda: probe_i16.probe_all_plain(xs), 50),
            # three inputs read once, six outputs written once; per
            # element 15 operations: add 1, add+sub 2, the column compare
            # and select 2, the cast 5, the roll's casts 2, the halving 3
            work=((3 + 6) * n_el * 2, 15 * n_el))
    r = rows["P"]
    dev_p = launch_ms(lambda: probe_i16.probe_all(*xs), 100, "probe_kernel")
    six_ms = sum(cuda_ms(lambda: probe_i16.probe_op(name, *xs[:n_in]), 50)
                 for name, (_, n_in, _) in probe_i16.OPS.items())
    print(f"P: {r['ms'] * 1e3:.2f} us a call of all six ops (CUDA events), "
          f"device " + (f"{dev_p * 1e3:.2f} us" if dev_p else "not measured")
          + f" (torch.profiler); six calls of one op {six_ms * 1e3:.2f} us; "
          f"torch expressions {r['plain_ms'] * 1e3:.2f} us; bound "
          f"{r['bound_ms'] * 1e3:.2f} us on {card}")
    del xs, xs_full, got

    # B5 at the full-resolution depth warp (r = max_warp = 16) and at the
    # finest flow level at flow_scale 4 (270x480, r = 4 + search = 6).
    # Unit-scale images, as the JAX package's own warp test, so the 1e-5
    # bound is meaningful; the kernel targets bit-equality with the twin.
    rng = np.random.default_rng(SEED)

    def plane(lo, hi, shape):
        return torch.from_numpy(
            rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)

    b5 = []
    for shape, r in (((H, W_SBS), 16), ((270, 480), 6)):
        img = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)
        fy, fx = plane(-r - 1, r + 1, shape), plane(-r - 1, r + 1, shape)
        got = warp.warp_bilinear_shifts(img, fy, fx, r)
        want = warp_bilinear_shifts_plain(img, fy, fx, r)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        n_ne = int((got != want).sum().item())
        check(err <= 1e-5, f"B5 differs from twin at {shape} r={r}: {err}")
        b5.append(dict(
            shape=shape, r=r, err=err, n_ne=n_ne,
            ms=cuda_ms(lambda: warp.warp_bilinear_shifts(img, fy, fx, r), 20),
            plain_ms=cuda_ms(
                lambda: warp_bilinear_shifts_plain(img, fy, fx, r), 3)))
        print(f"B5 warp {shape[0]}x{shape[1]} r={r}: max |err| {err} "
              f"({n_ne} values differ); {b5[-1]['ms']:.4f} ms/call vs plain "
              f"{b5[-1]['plain_ms']:.4f} ms/call on {card}")
    add_row("B5", at="ms/call, 1080x1920 r=16 (one per frame)",
            name="B5 warp", source="video3d_tpu_torch/csrc/warp.cu",
            replaces="video3d_tpu/kernels/warp.py:91",
            max_abs_err=max(b["err"] for b in b5), ms=b5[0]["ms"],
            plain_ms=b5[0]["plain_ms"],
            # image and two flow planes in, one plane out; two taps a pass
            work=(4 * H * W_SBS * 4, 20 * H * W_SBS))

    # B6 at the finest flow level at flow_scale 4: the public match of an
    # already warped frame, and the level step with the warp inside, its
    # incoming flow at the coarser level's 135x240
    shape = (270, 480)
    cur, prev_w = plane(0, 255, shape), plane(0, 255, shape)
    fy, fx = plane(-3, 3, shape), plane(-3, 3, shape)
    got = flowmatch.flow_match(cur, prev_w, fy, fx, 2, 3, 2.0)
    want = flow_match_plain(cur, prev_w, fy, fx, 2, 3, 2.0)
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    check(err <= 2e-4, f"B6 differs from twin: {err}")
    n6 = shape[0] * shape[1]
    add_row("B6", at="ms/call at 270x480, search 2, radius 3, tau 2",
            name="B6 flow_match", source="video3d_tpu_torch/csrc/flowmatch.cu",
            replaces="video3d_tpu/kernels/flowmatch.py:122", max_abs_err=err,
            ms=cuda_ms(lambda: flowmatch.flow_match(cur, prev_w, fy, fx, 2, 3,
                                                    2.0), 20),
            plain_ms=cuda_ms(lambda: flow_match_plain(cur, prev_w, fy, fx, 2,
                                                      3, 2.0), 3),
            # four planes in, two out; 25 candidates of separable 7x7 SADs
            # and the softargmin update
            work=(6 * n6 * 4, 25 * (2 * 7 + 6) * n6))
    prev = card_checks.smooth_plane(*shape, SEED + 3, dev)
    cur = flow_shift(prev, 1, -2).contiguous()
    cshape = (135, 240)
    fy, fx = plane(-3, 3, cshape), plane(-3, 3, cshape)
    r6 = 6  # ceil(4 / 1) + 2: the finest level at flow_scale 4

    def b6_level():
        return flowmatch.flow_level(cur, prev, fy, fx, 2, 3, 2.0, r6)

    def b6_level_plain():
        return flow_level_plain(cur, prev, fy, fx, 2, 3, 2.0, r6)

    got, want = b6_level(), b6_level_plain()
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    check(err <= 2e-4, f"B6 level step differs from twin: {err}")
    check(all(torch.equal(g, a) for g, a in zip(got, b6_level())),
          "B6 level step: two runs differ")
    ms6, dev6 = cuda_ms(b6_level, 20), device_ms(b6_level, 20)
    add_row("B6-level", at="ms/call at 270x480 from a 135x240 flow, r 6",
            name="B6 flow_level (level step, warp inside)",
            source="video3d_tpu_torch/csrc/flowmatch.cu",
            replaces="video3d_tpu/kernels/flowmatch.py:122", max_abs_err=err,
            ms=ms6, plain_ms=cuda_ms(b6_level_plain, 3),
            # cur, prev and two coarse flow planes in, two flow planes out;
            # LEVEL_OPS a pixel whatever implements them
            work=((4 * n6 + 2 * cshape[0] * cshape[1]) * 4, LEVEL_OPS * n6))
    print(f"B6 level step 270x480: max |err| {err} px; {ms6:.4f} ms/call "
          f"(CUDA events), device time (torch.profiler) "
          + (f"{dev6:.4f}" if dev6 else "not measured") + f" on {card}")

    # B5's EMA step after the flow, at 1080p from the 270x480 guide with
    # the depth gate on: unit-scale depth, as card_checks.check_ema_tail
    ema_p = FlowEMAParams()
    rq = max(1, int(round(ema_p.max_warp / 4)))
    depth_f = card_checks.smooth_plane(H, W_SBS, SEED + 4, dev, 1.0)
    prev_f = (flow_shift(depth_f, 2, -3) + 0.05 * torch.from_numpy(
        rng.standard_normal((H, W_SBS)).astype(np.float32)).to(dev)
              ).contiguous()
    g_q = card_checks.smooth_plane(*shape, SEED + 5, dev)
    pg_q = flow_shift(g_q, 0, 1).contiguous()
    fy, fx = plane(-rq - 1, rq + 1, shape), plane(-rq - 1, rq + 1, shape)
    ema_in = (ema_p, depth_f, prev_f, g_q, pg_q, fy, fx, rq)
    got = warp.ema_tail(*ema_in)
    want = ema_tail_plain(*ema_in)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(err <= 1e-4, f"B5 EMA step differs from twin: {err}")
    check(torch.equal(got, warp.ema_tail(*ema_in)),
          "B5 EMA step: two runs differ")
    ms5 = cuda_ms(lambda: warp.ema_tail(*ema_in), 20)
    dev5 = device_ms(lambda: warp.ema_tail(*ema_in), 20)
    nf, nq = H * W_SBS, shape[0] * shape[1]
    add_row("B5-ema", at="ms/call at 1080x1920 from a 270x480 guide, gate on",
            name="B5 ema_tail (EMA step, 3 launches)",
            source="video3d_tpu_torch/csrc/warp.cu",
            replaces="video3d_tpu/kernels/warp.py:91", max_abs_err=err,
            ms=ms5, plain_ms=cuda_ms(lambda: ema_tail_plain(*ema_in), 3),
            # depth and prev_out in, the frame out; g, prev_g and the flow
            # in at guide scale; EMA_OPS a full-resolution pixel and
            # GUIDE_OPS a guide pixel whatever implements them
            work=((3 * nf + 4 * nq) * 4, EMA_OPS * nf + GUIDE_OPS * nq))
    print(f"B5 EMA step 1080x1920: max |err| {err}; {ms5:.4f} ms/call "
          f"(CUDA events), device time (torch.profiler) "
          + (f"{dev5:.4f}" if dev5 else "not measured") + f" on {card}")
    del img, fy, fx, got, want, cur, prev_w, prev, depth_f, prev_f, ema_in

    # B5 and B6 at the small shapes of card_checks: the level step along
    # whole pyramids, the EMA step at guides from 5x7 to 540x960
    for case in card_checks.FLOW_LEVEL_CASES:
        card_checks.check_flow_level(dev, *case)
    for case in card_checks.EMA_CASES:
        card_checks.check_ema_tail(dev, *case)
    print(f"B6's level step holds its gate at {len(card_checks.FLOW_LEVEL_CASES)}"
          f" pyramids (5x7 to 540x960, 3 and 4 levels, r_lvl 3-9); B5's EMA "
          f"step at {len(card_checks.EMA_CASES)} shapes (gate on and off); "
          f"both give the same bits on a second run")
    torch.cuda.empty_cache()

    # B7a (attention_multihead) and B7b (attention_oneblock), one launch,
    # at DPT-large's attention shape (two keyframes, 16 heads, 577 tokens,
    # head dim 64) and the K=1 hybrid's (eight keyframes), in both dtypes,
    # and at two more sequence lengths; 577 is not a multiple of the
    # kernel's 64-key tile, nor are 130 and 1500
    b7 = {}
    for shape in ((2, 16, 577, 64), (8, 16, 577, 64), (1, 6, 130, 16),
                  (1, 4, 1500, 32)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev, dtype) for _ in range(3))
            sm = 1.0 / shape[-1] ** 0.5
            want = attention_plain(q, k, v, sm).float()
            for name, fn in (("B7a", lambda: attention.attention_multihead(
                                 q, k, v, sm)),
                             ("B7b", lambda: attention.attention_oneblock(
                                 q, k, v, sm))):
                got = fn().float()
                torch.cuda.synchronize()
                err = (got - want).abs()
                max_err = err.max().item()
                if dtype == torch.float32:
                    frac = float((err <= 1e-5).float().mean().item())
                    check(max_err <= 1e-5,
                          f"{name} f32 differs from twin at {shape}: {max_err}")
                else:
                    tol = 2.0 ** -7 * want.abs() + 2.0 ** -10
                    frac = float((err <= tol).float().mean().item())
                    check(frac >= 0.999,
                          f"{name} bf16 vs twin at {shape}: {frac} in bound")
                key = (name, shape, dtype)
                b7[key] = dict(err=max_err, frac=frac)
                line = (f"{name} attention {shape} {str(dtype)[6:]}: max "
                        f"|err| {max_err:.3e}, {frac:.6f} of outputs in bound")
                if shape[2] == 577:
                    sdpa = (lambda: torch.nn.functional.
                            scaled_dot_product_attention(q, k, v, scale=sm))
                    b7[key]["ms"] = cuda_ms(fn, 20)
                    b7[key]["plain_ms"] = cuda_ms(
                        lambda: attention_plain(q, k, v, sm), 20)
                    b7[key]["library_ms"] = cuda_ms(sdpa, 20)
                    line += (f"; {b7[key]['ms']:.4f} ms/call vs plain "
                             f"{b7[key]['plain_ms']:.4f}, SDPA "
                             f"{b7[key]['library_ms']:.4f} on {card}")
                    if dtype == torch.bfloat16:
                        dev_b7, dev_sdpa = device_ms(fn, 20), device_ms(sdpa, 20)
                        b7[key]["dev_ms"] = dev_b7
                        line += "; device time (torch.profiler) " + (
                            f"{dev_b7:.4f} vs SDPA {dev_sdpa:.4f} ms/call"
                            if dev_b7 and dev_sdpa else "not measured")
                print(line)
    del q, k, v, want, got, err
    # one kernel and one launch count: the DPT path calls B7a's entry,
    # whose heads_per_step changes nothing on the GPU
    for name, label, src_line, per_block in (
            ("B7a", "attention_multihead", 84,
             "heads_per_step 8, the DPT path's call"),
            ("B7b", "attention_oneblock", 116, "the same launch")):
        key = (name, (2, 16, 577, 64), torch.bfloat16)
        n_qkv = 2 * 16 * 577 * 64
        add_row(name, at=f"ms/call at (2, 16, 577, 64) bf16 (one ViT layer, "
                         f"two keyframes), {per_block}",
                name=f"{name} {label}",
                source="video3d_tpu_torch/csrc/attention.cu",
                replaces=f"video3d_tpu/kernels/attention.py:{src_line}",
                max_abs_err=max(e["err"] for kk, e in b7.items()
                                if kk[0] == name),
                ms=b7[key]["ms"], plain_ms=b7[key]["plain_ms"],
                library_ms=b7[key]["library_ms"],
                # q, k, v in and o out in bf16; QK^T and PV on bf16 units
                work=(4 * n_qkv * 2, 4 * 2 * 16 * 577 * 577 * 64, "bf16"))
    torch.cuda.empty_cache()
    for r in rows.values():
        lib_ms = ("none" if r["library_ms"] is None
                  else f"{r['library_ms']:.4f}")
        print(f"{r['name']}: matches its twin (max |err| {r['max_abs_err']}); "
              f"{r['ms']:.4f} vs plain {r['plain_ms']:.4f} {r['at']} "
              f"on {card}")
        print(f"{r['name']}: bound {r['bound_ms']:.4f} ({r['bound_by']}); "
              f"library call {lib_ms}; same units")

    # -- 4. the main path ----------------------------------------------------
    phase("4. the stereo path")
    def plain_depth(frames_np, params=p):
        """uint16 maps and left gray of the depth path on the plain twins."""
        x = torch.from_numpy(frames_np).to(dev)
        pgl, pgr = gray_pair(x)
        pcost = costvol.cost_volume_plain(pgl, pgr, params, inv)
        pdisp = sgm.vertical_sweeps_wta_plain(
            pcost, sgm.horizontal_sweeps_plain(pcost, params), params)
        pdisp = speckle_filter_device(pdisp, *sp_args)
        return disparity_to_uint16(pdisp, params.num_disparities), pgl

    counters = {  # kernel -> (wrapper module, its launch count)
        "B1": (costvol, "launches"), "B2": (sgm, "sweep_launches"),
        "B3": (sgm, "wta_launches"), "B4": (speckle, "launches"),
        "B5": (warp, "launches"), "B6": (flowmatch, "launches"),
        "B7": (attention, "launches"), "B8a": (sgm, "aggregate_launches"),
        "B8b": (wmajor, "transpose_launches"),
        "B8c": (wmajor, "sweep_launches"), "P": (probe_i16, "launches"),
    }

    def counts(reset: bool = False) -> dict:
        if reset:
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    def ran(c: dict, keys, what: str) -> list:
        """The launch counts of ``keys`` in ``c``; fails if one is 0."""
        n = [c[k] for k in keys]
        check(all(k > 0 for k in n), f"a kernel never ran on {what}: "
              f"{dict(zip(keys, n))}")
        return n

    def read_maps(cache, n):
        files = list_depth_frames(cache)
        check(len(files) == n, f"{len(files)} PNGs for {n} frames")
        maps = np.stack([load_depth_png16(f) for f in files])
        check(maps.shape == (n, H, W_SBS) and maps.dtype == np.uint16,
              f"maps {maps.shape} {maps.dtype}")
        return maps

    def check_disparity(maps, what):
        disp_px = maps.astype(np.float64) * (p.num_disparities / 65535.0)
        valid = maps > 0
        frac = float(valid.mean())
        med = float(np.median(disp_px[valid]))
        print(f"{what}: valid fraction {frac:.4f}; median disparity "
              f"{med:.4f} px (shift {2 * SHIFT_EYE} px)")
        check(0.5 < frac <= 1.0, f"{what}: valid fraction {frac}")
        check(abs(med - 2 * SHIFT_EYE) <= 0.5,
              f"{what}: median disparity {med}")

    work = Path(tempfile.mkdtemp(prefix="v3d_smoke_"))
    try:
        ext = StereoDepthExtractor(work_dir=str(work), guidance="none",
                                   device=dev)
        batch = ext._auto_batch_size(H, W_SBS)
        batches = [(sbs_frames(batch, SEED + 1 + i), batch) for i in range(2)]
        cache = work / "depth_smoke"
        counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = ext._run_batches(batches, cache)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = ran(counts(), ("B1", "B2", "B3", "B4"), "the main path")
        print(f"main path: {n} frames in batches of {batch}, "
              f"{run_s:.3f} s incl. first-batch warm-up and PNG writes; "
              f"launches B1..B4 = {launches}")
        for key, k in zip(("B1", "B2", "B3", "B4"), launches):
            rows[key]["launches"] = k
        rows["B1-i16"]["launches"] = launches[0]
        # the stage runs batches of 8: the same launches, at the @8 rows'
        # shape
        for key, k in zip(("B1@8", "B2@8", "B3@8", "B4@8"), launches):
            rows[key]["launches"] = k
        check(n == 2 * batch, f"wrote {n} frames")
        maps = read_maps(cache, n)
        check_disparity(maps, "main path")

        # the first batch's maps against the plain path on the card
        plain_maps, _ = plain_depth(batches[0][0])
        plain_maps = plain_maps.cpu().to(torch.int32).numpy()
        n_diff = int((plain_maps != maps[:batch].astype(np.int32)).sum())
        print(f"batch 0 uint16 maps vs plain path: {n_diff} pixels differ")
        check(n_diff == 0, "main path differs from the plain path")
        torch.cuda.empty_cache()

        # -- 4b. the flow-smoothed path --------------------------------------
        phase("4b. the flow path")
        fext = StereoDepthExtractor(work_dir=str(work), guidance="none",
                                    device=dev, temporal_smooth="flow")
        fbatch = fext._auto_batch_size(H, W_SBS)
        clip = pan_frames(2 * fbatch, SEED + 10)
        fbatches = [(clip[i * fbatch:(i + 1) * fbatch], fbatch)
                    for i in range(2)]
        fcache = work / "depth_flow"
        counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_flow = fext._run_batches(fbatches, fcache)
        torch.cuda.synchronize()
        flow_s = time.perf_counter() - t0
        flaunches = ran(counts(), ("B1", "B2", "B3", "B4", "B5", "B6"),
                        "the flow path")
        print(f"flow path: {n_flow} frames in batches of {fbatch}, "
              f"{flow_s:.3f} s "
              f"incl. first-batch warm-up and PNG writes; launches B1..B6 = "
              f"{flaunches}")
        # one counter per source: the path launches only the fused forms
        rows["B5"]["launches"] = rows["B5-ema"]["launches"] = flaunches[4]
        rows["B6"]["launches"] = rows["B6-level"]["launches"] = flaunches[5]
        n_smoothed = n_flow - 1  # frame 0 passes through
        print(f"flow path: B5 {flaunches[4] / n_smoothed:.2f} and B6 "
              f"{flaunches[5] / n_smoothed:.2f} launches per smoothed frame "
              f"({n_smoothed} frames)")
        check(n_flow == 2 * fbatch, f"wrote {n_flow} frames")
        fmaps = read_maps(fcache, n_flow)
        check_disparity(fmaps, "flow path")

        # frame 0 passes through: the unsmoothed map of the kernel path
        raw, guide0 = depth_batch_pipeline(
            torch.from_numpy(fbatches[0][0]).to(dev), return_guide=True)
        raw_np = raw.cpu().to(torch.int32).numpy()
        check(np.array_equal(raw_np[0], fmaps[0].astype(np.int32)),
              "flow path frame 0 differs from the unsmoothed map")
        n_sm = int((raw_np[1:] != fmaps[1:fbatch].astype(np.int32)).sum())
        print(f"flow path: frame 0 equals the unsmoothed map; the smoother "
              f"changed {n_sm} pixels of frames 1..{fbatch - 1}")

        # the motion of the pan on two consecutive guides (1/4 scale)
        rq = max(1, int(round(FlowEMAParams().max_warp / 4)))
        fy, fx = estimate_flow_fast(guide0[1], guide0[0], max_flow=rq)
        pan = 2 * PAN_EYE / 4  # eye px -> unsqueezed px -> guide px
        med_fx, med_fy = fx.median().item(), fy.median().item()
        print(f"flow of the pan at the 1/4 guide: median x {med_fx:.4f} px, "
              f"y {med_fy:.4f} px (pan {pan} px, 0 px)")
        check(abs(med_fx - pan) <= 0.25, f"median x-flow {med_fx}")
        check(abs(med_fy) <= 0.25, f"median y-flow {med_fy}")

        # batch 0 against the same path on the plain twins: the depth twins
        # on the card, the smoother's twins on the CPU
        pmaps, pgl = plain_depth(fbatches[0][0])
        n_diff = int((pmaps != raw).sum().item())
        check(n_diff == 0, f"flow path raw maps differ from plain: {n_diff}")
        pguide = resize2d(pgl, -(-H // 4), -(-W_SBS // 4), "bilinear")
        t0 = time.perf_counter()
        twin = TemporalFlowEMAStream().push(pmaps.cpu(), pguide.cpu())
        twin_s = time.perf_counter() - t0
        d = np.abs(twin.to(torch.int32).numpy()
                   - fmaps[:fbatch].astype(np.int32))
        frac = float((d <= 16).mean())
        print(f"flow path batch 0 vs plain twins (smoother on the CPU, "
              f"{twin_s:.1f} s): {frac:.6f} of pixels within 16 uint16 units "
              f"(1/64 px), max |diff| {int(d.max())}")
        check(frac >= 0.999, f"flow path vs twins: {frac} within 16")
        del raw, guide0, pmaps, pgl, pguide, fy, fx
        torch.cuda.empty_cache()

        # -- 4c. the DPT hybrid path -----------------------------------------
        phase("4c. the hybrid path")
        # DPT-large at full width and depth, random bf16 weights from seed 0
        # (no checkpoint ships with the repository)
        t0 = time.perf_counter()
        gfn = random_dpt_guidance(seed=0, device=dev)
        torch.cuda.synchronize()
        n_par = sum(t.numel() for t in gfn.module.parameters())
        print(f"DPT-large: {n_par} parameters, "
              f"{next(gfn.module.parameters()).dtype}, random from seed 0 in "
              f"{time.perf_counter() - t0:.1f} s")
        hext = StereoDepthExtractor(work_dir=str(work), guidance="dpt",
                                    batch_size=8, device=dev)
        hext._guidance_fn, hext._guidance_loaded = gfn, True
        hbatches = [(sbs_frames(8, SEED + 20 + i), 8) for i in range(2)]
        hcache = work / "depth_hybrid"
        counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_hyb = hext._run_batches(hbatches, hcache)
        torch.cuda.synchronize()
        hyb_s = time.perf_counter() - t0
        hc = counts()
        hlaunches = [hc[k] for k in ("B1", "B2", "B3", "B4", "B5", "B6",
                                     "B7")]
        print(f"hybrid path: {n_hyb} frames in batches of 8, K="
              f"{hext.guidance_every}, fill {hext.fill_holes}, blend "
              f"{hext.blend}, {hyb_s:.3f} s incl. first-batch warm-up and PNG "
              f"writes; launches B1..B7 = {hlaunches}")
        check(n_hyb == 16, f"wrote {n_hyb} frames")
        check(hlaunches[:4] == [2, 2, 2, 2] and hlaunches[4:6] == [0, 0],
              f"hybrid path launches {hlaunches}")
        check(hlaunches[6] == 2 * 24,
              f"B7 launches {hlaunches[6]}, expected 24 per batch")
        rows["B7a"]["launches"] = rows["B7b"]["launches"] = hlaunches[6]
        hmaps = read_maps(hcache, n_hyb)

        # batch 0 step by step on the kernels: fill, finite blend, and the
        # same maps as the run
        x0 = torch.from_numpy(hbatches[0][0]).to(dev)
        left, right = rgb_eyes(x0)
        hgl = rgb_to_gray(left).contiguous()
        hgr = rgb_to_gray(right).contiguous()
        disp, conf = sgbm_disparity(hgl, hgr, p, return_margin=True)
        filled = fill_holes(disp, float(p.min_disparity - 1))
        holes = filled == float(p.min_disparity - 1)
        rows_valid = (disp != float(p.min_disparity - 1)).any(-1, keepdim=True)
        n_left = int((holes & rows_valid).sum().item())
        print(f"hybrid batch 0: {int((disp < 0).sum().item())} invalid pixels "
              f"before the fill, {int(holes.sum().item())} after, {n_left} "
              f"of them in rows with a valid pixel")
        check(n_left == 0, f"{n_left} holes left in rows with a valid pixel")
        blended = guidance_blend(filled, conf, left, right, gfn, p,
                                 guidance_every=4)
        check(bool(torch.isfinite(blended).all()), "hybrid blend not finite")
        step = disparity_to_uint16(blended, p.num_disparities).cpu().to(
            torch.int32).numpy()
        d = np.abs(step - hmaps[:8].astype(np.int32))
        print(f"hybrid batch 0 step by step vs the run: max |diff| "
              f"{int(d.max())} uint16 units")
        check(int(d.max()) <= 1, "hybrid batch 0 differs from its steps")
        disp_px = hmaps[:8].astype(np.float64) * (p.num_disparities / 65535.0)
        med = float(np.median(disp_px))
        stereo = disp.cpu().numpy()
        moved = float((np.abs(disp_px - np.clip(stereo, 0, None))[
            stereo >= 0] > 0.25).mean())
        print(f"hybrid batch 0: median disparity {med:.4f} px (shift "
              f"{2 * SHIFT_EYE} px; stereo alone "
              f"{float(np.median(stereo[stereo >= 0])):.4f}); the blend moved "
              f"{moved:.6f} of the valid stereo pixels by more than 1/4 px")
        check(abs(med - 2 * SHIFT_EYE) <= 0.5, f"hybrid median {med}")

        # batch 0 against the same path with every kernel swapped for its
        # twin (B1-B4 on the card; B7's twin through the same DPT)
        with twins():
            counts(reset=True)
            tmaps = depth_batch_pipeline(
                x0, guidance_fn=gfn, guidance_every=4,
                fill_holes=True).cpu().to(torch.int32).numpy()
            check(not any(counts().values()),
                  f"twin run launched {counts()}")
        d = np.abs(tmaps - hmaps[:8].astype(np.int32))
        within = float((d <= 64).mean())
        print(f"hybrid batch 0 vs the twins: {float((d == 0).mean()):.6f} of "
              f"pixels equal, {within:.6f} within 64 uint16 units (1/16 px), "
              f"max |diff| {int(d.max())}")
        check(within >= 0.99, f"hybrid path vs twins: {within} within 64")
        del x0, left, right, hgl, hgr, disp, conf, filled, holes, blended
        torch.cuda.empty_cache()

        # -- 4d. MODE_HH: 8 paths, f32 accumulator, bottom-up close --------
        phase("4d. the MODE_HH path")
        hh_ext = StereoDepthExtractor(work_dir=str(work), guidance="none",
                                      batch_size=8, device=dev, params=p8)
        hh_batches = [(sbs_frames(8, SEED + 30 + i), 8) for i in range(2)]
        hh_cache = work / "depth_hh"
        counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_hh = hh_ext._run_batches(hh_batches, hh_cache)
        torch.cuda.synchronize()
        hh_s = time.perf_counter() - t0
        hh_launches = ran(counts(), ("B1", "B2", "B3", "B4"), "the MODE_HH path")
        print(f"MODE_HH path: {n_hh} frames in batches of 8, {hh_s:.3f} s "
              f"incl. first-batch warm-up and PNG writes = "
              f"{n_hh / hh_s:.2f} frames/s on {card}; launches B1..B4 = "
              f"{hh_launches}")
        rows["B2-hh"]["launches"], rows["B3-hh"]["launches"] = hh_launches[1:3]
        rows["B3-hh@8"]["launches"] = hh_launches[2]
        check(n_hh == 16, f"wrote {n_hh} frames")
        hh_maps = read_maps(hh_cache, n_hh)
        check_disparity(hh_maps, "MODE_HH path")
        counts(reset=True)
        plain_maps, _ = plain_depth(hh_batches[0][0], p8)
        check(not any(counts().values()), "the plain path launched a kernel")
        n_diff = int((plain_maps.cpu().to(torch.int32).numpy()
                      != hh_maps[:8].astype(np.int32)).sum())
        print(f"MODE_HH batch 0 uint16 maps vs the all-twin path: {n_diff} "
              f"pixels differ")
        check(n_diff == 0, "MODE_HH path differs from the all-twin path")
        del plain_maps
        torch.cuda.empty_cache()

        # -- 4e. the W-major horizontal routes, 5 and 8 paths ----------------
        phase("4e. the routes")
        rgl, rgr = gray_pair(torch.from_numpy(hh_batches[1][0]).to(dev))
        route_launches = {}
        for pp in (p, p8):
            counts(reset=True)
            legacy = sgbm_disparity(rgl, rgr, pp)
            for route in ("xla", "mxu"):
                got = sgbm_disparity(rgl, rgr, pp, horizontal_route=route)
                check(torch.equal(got, legacy),
                      f"route {route} at {pp.num_paths} paths differs from "
                      f"legacy")
            print(f"routes xla and mxu at {pp.num_paths} paths: disparities "
                  f"equal to legacy's bit for bit (batch of 8, valid "
                  f"{float((legacy >= 0).float().mean()):.4f})")
            n8b, n8c = route_launches[pp.num_paths] = ran(
                counts(), ("B8b", "B8c"), f"the routes at {pp.num_paths} "
                f"paths")
            check(n8c == 2, f"B8c launched {n8c} times for two route calls")
            print(f"routes at {pp.num_paths} paths: launches B8b, B8c = "
                  f"{[n8b, n8c]} (one B8c launch a route call)")
        rows["B8b"]["launches"] = route_launches[5][0] + route_launches[8][0]
        rows["B8c"]["launches"] = route_launches[5][1]
        rows["B8c-f32"]["launches"] = route_launches[8][1]
        del legacy, got, rgl, rgr
        torch.cuda.empty_cache()

        # -- 4f. B8a through the public sgm_aggregate_pallas ------------------
        phase("4f. sgm_aggregate_pallas")
        # on the f32 and bf16 cost volume of two 1080p frames at 8 and 5
        # paths
        counts(reset=True)
        agl, agr = gray_pair(torch.from_numpy(sbs_frames(B, SEED + 40)).to(dev))
        acost = costvol.cost_volume(agl, agr, p, inv)
        for key, dt, paths in (
                ("B8a-f32", torch.float32, 8), ("B8a-bf16", torch.bfloat16, 8),
                ("B8a-f32-5", torch.float32, 5),
                ("B8a-bf16-5", torch.bfloat16, 5)):
            before = sgm.aggregate_launches
            agg = kernels_api.sgm_aggregate_pallas(acost.to(dt), paths)
            check(agg.dtype == torch.float32 and bool(torch.isfinite(agg).all())
                  and agg.shape == acost.shape, f"{key} output")
            rows[key]["launches"] = sgm.aggregate_launches - before
            print(f"{key}: {sgm.aggregate_plan[0]} kernel launches a call")
        ran(counts(), ("B8a",), "sgm_aggregate_pallas")
        print(f"sgm_aggregate_pallas: launches B8a = {sgm.aggregate_launches}")
        del agl, agr, acost, agg
        torch.cuda.empty_cache()

        # -- 4g. the int16 probe's own run ------------------------------------
        phase("4g. the probe")
        counts(reset=True)
        check(probe_i16.main([]) == 0, "the int16 probe failed")
        rows["P"]["launches"] = ran(counts(), ("P",), "the probe")[0]
        check(rows["P"]["launches"] == 2,
              f"the probe made {rows['P']['launches']} launches, not 2")

        # -- 4h. the CREStereo hybrid, the shipped default ------------------
        phase("4h. the CREStereo hybrid (the default)")
        # no guidance argument: the stage's default, on the bundled weights
        cext = StereoDepthExtractor(work_dir=str(work), batch_size=8)
        t0 = time.perf_counter()
        cext.load_model()
        check(cext.guidance == "crestereo" and cext._guidance_fn is not None
              and cext.model_checkpoint == str(BUNDLED_WEIGHTS),
              f"the default guidance did not load: {cext.guidance} from "
              f"{cext.model_checkpoint}")
        cfn = cext._guidance_fn
        print(f"CREStereo: {sum(t.numel() for t in cfn.module.parameters())}"
              f" parameters from {Path(cext.model_checkpoint).name} in "
              f"{time.perf_counter() - t0:.1f} s, convs in "
              f"{cfn.module.cfg.dtype}, on {next(cfn.module.parameters()).device}")
        forwards = []
        hook = cfn.module.register_forward_hook(
            lambda mod, args, out: forwards.append(args[0].shape[0]))
        cbatches = [(sbs_frames(8, SEED + 60 + i), 8) for i in range(2)]
        ccache = work / "depth_crestereo"
        counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_cre = cext._run_batches(cbatches, ccache)
        torch.cuda.synchronize()
        cre_s = time.perf_counter() - t0
        hook.remove()
        cc = counts()
        claunches = [cc[k] for k in ("B1", "B2", "B3", "B4", "B5", "B6",
                                     "B7")]
        print(f"CREStereo hybrid: {n_cre} frames in batches of 8, K="
              f"{cext.guidance_every}, fill {cext.fill_holes}, blend "
              f"{cext.blend}, {cre_s:.3f} s incl. first-batch warm-up and "
              f"PNG writes; launches B1..B7 = {claunches}; guidance "
              f"forwards {len(forwards)} of {forwards} keyframes")
        check(cext.guidance == "crestereo",
              f"the run degraded to {cext.guidance}")
        check(n_cre == 16, f"wrote {n_cre} frames")
        check(claunches == [2, 2, 2, 2, 0, 0, 0],
              f"CREStereo hybrid launches {claunches}")
        check(forwards == [2, 2], f"guidance forwards {forwards}, expected "
              f"one of 2 keyframes a batch (K=4)")
        # the default is now the system's main path: B1-B4's launches
        for key, k in zip(("B1", "B2", "B3", "B4"), claunches):
            rows[key]["launches"] = rows[key + "@8"]["launches"] = k
        rows["B1-i16"]["launches"] = claunches[0]
        cmaps = read_maps(ccache, n_cre)
        disp_px = cmaps.astype(np.float64) * (p.num_disparities / 65535.0)
        med = float(np.median(disp_px))
        print(f"CREStereo hybrid: median disparity {med:.4f} px (shift "
              f"{2 * SHIFT_EYE} px), {float((cmaps > 0).mean()):.4f} of "
              f"pixels > 0")
        check(abs(med - 2 * SHIFT_EYE) <= 0.5, f"CREStereo median {med}")

        # batch 0 step by step on the kernels
        x0 = torch.from_numpy(cbatches[0][0]).to(dev)
        left, right = rgb_eyes(x0)
        disp, conf = sgbm_disparity(rgb_to_gray(left).contiguous(),
                                    rgb_to_gray(right).contiguous(), p,
                                    return_margin=True)
        filled = fill_holes(disp, float(p.min_disparity - 1))
        guide = cfn(left[::4], right[::4])
        check(guide.shape == (2, H, W_SBS) and bool(torch.isfinite(guide).all()),
              f"CREStereo guide {tuple(guide.shape)}")
        gmed = float(guide.median().item())
        print(f"CREStereo guide alone: median {gmed:.4f} px")
        blended = guidance_blend(filled, conf, left, right, cfn, p,
                                 guidance_every=4)
        check(bool(torch.isfinite(blended).all()), "CREStereo blend not finite")
        step = disparity_to_uint16(blended, p.num_disparities).cpu().to(
            torch.int32).numpy()
        d = np.abs(step - cmaps[:8].astype(np.int32))
        print(f"CREStereo batch 0 step by step vs the run: max |diff| "
              f"{int(d.max())} uint16 units")
        check(int(d.max()) <= 1, "CREStereo batch 0 differs from its steps")

        # batch 0 with B1-B4 swapped for their twins
        with twins():
            counts(reset=True)
            tmaps = depth_batch_pipeline(
                x0, guidance_fn=cfn, guidance_every=4,
                fill_holes=True).cpu().to(torch.int32).numpy()
            check(not any(counts().values()),
                  f"twin run launched {counts()}")
        d = np.abs(tmaps - cmaps[:8].astype(np.int32))
        within = float((d <= 64).mean())
        print(f"CREStereo batch 0 vs the twins: {float((d == 0).mean()):.6f} "
              f"of pixels equal, {within:.6f} within 64 uint16 units (1/16 "
              f"px), max |diff| {int(d.max())}")
        check(within >= 0.99, f"CREStereo path vs twins: {within} within 64")

        # the bf16 model on the card against the f32 model on the CPU, one
        # 1080p keyframe pair (half-resolution inference)
        cpu_fn = load_crestereo_guidance(dtype=torch.float32, device="cpu")
        t0 = time.perf_counter()
        g_cpu = cpu_fn(left[:1].cpu(), right[:1].cpu())
        cpu_s = time.perf_counter() - t0
        g_card = cfn(left[:1], right[:1]).cpu()
        d = (g_card - g_cpu).abs()
        frac = float((d <= 0.5).float().mean().item())
        dmed = float(d.median().item())
        print(f"CREStereo bf16 on the card vs f32 on the CPU ({cpu_s:.1f} s), "
              f"one 1080p pair: {frac:.6f} of pixels within 0.5 px (bound "
              f">= 0.99), median |diff| {dmed:.4f} px (bound <= 0.1), max "
              f"{float(d.max().item()):.4f}; medians {float(g_card.median()):.4f}"
              f" / {float(g_cpu.median()):.4f} px")
        check(frac >= 0.99 and dmed <= 0.1,
              "CREStereo bf16 on the card differs from f32 on the CPU")
        del x0, disp, conf, filled, blended, guide, g_cpu, g_card, cpu_fn
        torch.cuda.empty_cache()

        # -- 4i. the upscale ---------------------------------------------------
        phase("4i. the upscale")
        # a resident batch of 4: the CREStereo maps (1080x1920 uint16) to
        # 2160x3840, guided by the left eyes at 2x (nearest), uint16 out
        H4, W4 = 2 * H, 2 * W_SBS
        up_depth = torch.from_numpy(cmaps[:4]).to(dev)
        up_guide = left[:4].round().clamp(0, 255).to(torch.uint8)
        up_guide = up_guide.repeat_interleave(2, 1).repeat_interleave(2, 2)
        del left, right
        up_ops = {
            "adaptive": lambda d, g: guided.adaptive_upsample(
                d, g, H4, W4, out_dtype="uint16"),
            "guided gray": lambda d, g: guided.guided_upsample(
                d, g, H4, W4, out_dtype="uint16"),
            "guided color": lambda d, g: guided.guided_upsample(
                d, g, H4, W4, guide_mode="color", out_dtype="uint16"),
            "plain": lambda d, g: guided.plain_upsample(
                d, H4, W4, out_dtype="uint16"),
        }
        counts(reset=True)
        for name, fn in up_ops.items():
            got = fn(up_depth, up_guide).cpu().to(torch.int32)
            t0 = time.perf_counter()
            want = fn(up_depth.cpu(), up_guide.cpu()).to(torch.int32)
            cpu_s = time.perf_counter() - t0
            check(got.shape == (4, H4, W4), f"{name} shape {tuple(got.shape)}")
            d = (got - want).abs()
            frac = float((d <= 1).float().mean().item())
            print(f"upscale {name} 4x1080x1920 -> 2160x3840 on the card vs "
                  f"f32 on the CPU ({cpu_s:.1f} s): max |diff| "
                  f"{int(d.max().item())} uint16 units (bound 2), "
                  f"{frac:.6f} within 1 (bound >= 0.999), "
                  f"{float((d == 0).float().mean().item()):.6f} equal")
            check(int(d.max().item()) <= 2 and frac >= 0.999,
                  f"upscale {name} differs from its CPU run")
        check(not any(counts().values()), f"the upscale launched {counts()}")
        del got, want, d

        # the stage: a synthetic 3840x2160 guide clip written on the card's
        # host, the CREStereo maps, once to PNG16 and once to mp4
        clip4k = work / "guide_4k.mp4"
        with VideoWriter(str(clip4k), W4, H4, 24.0, preset="ultrafast") as vw:
            for f in up_guide.cpu().numpy():
                vw.write(f)
            for f in up_guide.flip(2).cpu().numpy():
                vw.write(f)
        upscaler = DepthUpscaler(work_dir=str(work / "up"), batch_size=4,
                                 preset="veryfast")
        t0 = time.perf_counter()
        out_png = upscaler.process_depth_upscaling(str(ccache), str(clip4k),
                                                   png16_out=True)
        png_s = time.perf_counter() - t0
        ups = [load_depth_png16(f) for f in list_depth_frames(out_png)]
        check(len(ups) == 16 and ups[0].shape == (H4, W4)
              and ups[0].dtype == np.uint16, f"upscaled PNGs {len(ups)}")
        check(out_png.name == f"depth_4k_{ccache.name}_adaptive",
              f"upscale output {out_png.name}")
        print(f"DepthUpscaler (adaptive, png16_out): 16 frames in "
              f"{png_s:.2f} s incl. decode and PNG writes -> {out_png.name}, "
              f"writer {upscaler.writer_backend}")
        t0 = time.perf_counter()
        out_mp4 = upscaler.process_depth_upscaling(str(ccache), str(clip4k),
                                                   max_frames=8)
        mp4_s = time.perf_counter() - t0
        check(out_mp4.is_file() and out_mp4.stat().st_size > 0,
              f"no mp4 at {out_mp4}")
        print(f"DepthUpscaler (adaptive, mp4): 8 frames in {mp4_s:.2f} s "
              f"-> {out_mp4.name} ({out_mp4.stat().st_size} bytes), writer "
              f"backend {upscaler.writer_backend}")
        del ups
        torch.cuda.empty_cache()

        # -- 5. stage frames/s on the device (no PNG writes) ---------------
        phase("5. timings")
        xb = torch.from_numpy(batches[1][0]).to(dev)
        ms = cuda_ms(lambda: depth_batch_pipeline(xb), 3)
        fps = batch * 1000.0 / ms
        print(f"stage: {ms:.3f} ms per batch of {batch} = {fps:.2f} frames/s "
              f"(1080p SBS, stereo-only, device time) on {card}")
        print(f"main path incl. PNG writes: {n / run_s:.2f} frames/s on {card}")

        # MODE_HH and the routes on one batch of 8, each beside legacy
        xr = torch.from_numpy(hh_batches[1][0]).to(dev)
        for pp in (p, p8):
            for route in ("legacy", "xla", "mxu"):
                ms_r = cuda_ms(lambda: depth_batch_pipeline(
                    xr, params=pp, horizontal_route=route), 3)
                print(f"stage {pp.num_paths} paths, route {route}: "
                      f"{ms_r:.3f} ms per batch of 8 = {8000.0 / ms_r:.2f} "
                      f"frames/s (device time) on {card}")
        print(f"MODE_HH path incl. PNG writes: {n_hh / hh_s:.2f} frames/s on "
              f"{card}")
        del xr

        xf = torch.from_numpy(fbatches[1][0]).to(dev)
        stream = TemporalFlowEMAStream()

        def flow_stage():
            depth, guide = depth_batch_pipeline(xf, return_guide=True)
            stream.push(depth, guide)

        ms_f = cuda_ms(flow_stage, 3)  # the warm-up call seeds the carry
        print(f"stage with the flow smoother: {ms_f:.3f} ms per batch of "
              f"{fbatch} = {fbatch * 1000.0 / ms_f:.2f} frames/s (device "
              f"time) on {card}")
        print(f"flow path incl. PNG writes: {n_flow / flow_s:.2f} frames/s on "
              f"{card}")

        # the DPT hybrid: the network per keyframe, the guidance fn (with
        # its resizes) per keyframe, and the stage at K=4 and K=1 beside
        # stereo-only on the same batch
        xh = torch.from_numpy(hbatches[1][0]).to(dev)
        x384 = torch.from_numpy(rng.uniform(
            -1, 1, (2, 384, 384, 3)).astype(np.float32)).to(dev, torch.bfloat16)
        with torch.no_grad():
            ms_net = cuda_ms(lambda: gfn.module(x384), 5) / 2
        lh, _ = rgb_eyes(xh)
        ms_gfn = cuda_ms(lambda: gfn(lh[::4]), 5) / 2
        print(f"DPT-large forward: {ms_net:.3f} ms per keyframe (batch of 2 at "
              f"384x384, bf16); guidance fn incl. resizes {ms_gfn:.3f} ms per "
              f"keyframe on {card}")
        ms_stereo = cuda_ms(lambda: depth_batch_pipeline(xh), 3)
        for kev in (4, 1):
            ms_h = cuda_ms(lambda: depth_batch_pipeline(
                xh, guidance_fn=gfn, guidance_every=kev, fill_holes=True), 3)
            # 24 ViT layers, one B7 call each, on the batch's 8 / K keyframes
            dev_b7 = b7[("B7b", (8 // kev, 16, 577, 64),
                         torch.bfloat16)].get("dev_ms")
            share = ("B7 not measured" if dev_b7 is None else
                     f"B7 24 x {dev_b7:.4f} ms device = "
                     f"{100.0 * 24 * dev_b7 / ms_h:.2f}% of the batch")
            print(f"hybrid stage K={kev}: {ms_h:.3f} ms per batch of 8 = "
                  f"{8000.0 / ms_h:.2f} frames/s (stereo-only on the same "
                  f"batch {8000.0 / ms_stereo:.2f}; device time; {share}) "
                  f"on {card}")
        print(f"hybrid path incl. PNG writes: {n_hyb / hyb_s:.2f} frames/s on "
              f"{card}")
        del xh, x384, lh

        # the CREStereo hybrid: the stage at K=4 and K=1, one keyframe's
        # forward (half resolution, bf16) and the guidance fn with its
        # resizes, each over repeats
        xc = torch.from_numpy(cbatches[1][0]).to(dev)
        ms_stereo = spread(event_times(lambda: depth_batch_pipeline(xc), 5))
        for kev in (4, 1):
            t = event_times(lambda: depth_batch_pipeline(
                xc, guidance_fn=cfn, guidance_every=kev, fill_holes=True), 5)
            print(f"CREStereo hybrid stage K={kev}: {spread(t)} per batch of "
                  f"8 = {8000.0 / float(np.median(t)):.2f} frames/s (device "
                  f"time; stereo-only on the same batch {ms_stereo}) on "
                  f"{card}")
        lc, rc = rgb_eyes(xc[:1])
        hs, ws = H // 2, W_SBS // 2
        ls, rs = (resize2d(e.movedim(-1, 1), hs, ws, "bilinear").movedim(1, -1)
                  for e in (lc, rc))
        with torch.no_grad():
            t_fwd = event_times(lambda: cfn.module(ls, rs), 10)
            dev_fwd = device_ms(lambda: cfn.module(ls, rs), 5)
        t_gfn = event_times(lambda: cfn(lc, rc), 10)
        flops = conv_flops(cfn.module.cfg, hs, ws)
        b_ms, b_by = bound(2 * hs * ws * 3 * 4 + H * W_SBS * 4, flops,
                           "bf16")
        print(f"CREStereo forward, one keyframe at {hs}x{ws} (bf16 convs): "
              f"{spread(t_fwd)} CUDA events, device time (torch.profiler) "
              + (f"{dev_fwd:.3f} ms" if dev_fwd else "not measured")
              + f"; guidance fn incl. resizes at 1080x1920 {spread(t_gfn)} "
              f"on {card}")
        print(f"CREStereo forward: {flops / 1e9:.2f} GFLOP of convs a "
              f"keyframe (models/crestereo.py conv_flops), bound "
              f"{b_ms:.4f} ms ({b_by}, 989 TFLOP/s bf16)")
        with torch.no_grad():
            n_ops, per = profile_kernels(lambda: cfn.module(ls, rs), 3)
        print(f"CREStereo forward (torch.profiler): {n_ops:.0f} device "
              f"operations a keyframe, "
              f"{sum(ms for _, ms in per.values()):.3f} ms; by device time:")
        print_top(per)
        del xc, lc, rc, ls, rs

        # adaptive_upsample per 4K frame on the resident batch of 4
        for name in ("adaptive", "guided gray", "guided color", "plain"):
            t = event_times(lambda: up_ops[name](up_depth, up_guide), 5)
            print(f"upscale {name}: {spread(t)} per batch of 4 = "
                  f"{float(np.median(t)) / 4:.3f} ms per 2160x3840 frame on "
                  f"{card}")
        n_ops, per = profile_kernels(
            lambda: up_ops["adaptive"](up_depth, up_guide), 2)
        print(f"upscale adaptive (torch.profiler): {n_ops:.0f} device "
              f"operations a batch of 4, "
              f"{sum(ms for _, ms in per.values()):.3f} ms; by device time:")
        print_top(per)
        del up_depth, up_guide

        # the smoother alone, shaped as the JAX package's bench_smooth: T=8
        # uint16 1080p depth, 270x480 guide, one scan from frame 0
        srng = np.random.default_rng(2)
        sd = torch.from_numpy(srng.integers(0, 65535, (8, H, W_SBS))
                              .astype(np.uint16)).to(dev)
        sg = torch.from_numpy(srng.integers(0, 255, (8, 270, 480))
                              .astype(np.float32)).to(dev)
        ms_s = cuda_ms(lambda: flow_ema_scan(None, sd, sg, FlowEMAParams()),
                       3) / 8
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flow_ema_scan(None, sd, sg, FlowEMAParams())
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1000.0 / 8
        print(f"smoother alone: {ms_s:.3f} ms/frame CUDA events, "
              f"{host_ms:.3f} ms/frame host clock (T=8, 1080p depth, "
              f"270x480 guide) = {1000.0 / ms_s:.2f} frames/s on {card}")
        # the smoother's launches per frame, counted in a profiler trace
        n_dev, per = profile_kernels(
            lambda: flow_ema_scan(None, sd, sg, FlowEMAParams()), 1)
        print(f"smoother launches (torch.profiler): {n_dev:.0f} device "
              f"operations for 8 frames = {n_dev / 8:.2f} per frame on {card}")
        for name, (k, _) in sorted(per.items(), key=lambda kv: -kv[1][0]):
            print(f"  {k / 8:6.2f} per frame  {name[:100]}")
        check(0 < n_dev <= 20 * 8,
              f"the smoother ran {n_dev / 8:.2f} device operations a frame, "
              f"more than 20")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [dict(name=r["name"], route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=r["launches"],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for r in rows.values()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
