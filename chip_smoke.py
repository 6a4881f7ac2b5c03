"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the environment (torch, CUDA, nvcc, card name and power limit,
   TF32 flags, PNG writers available);
2. builds the port's CUDA kernels from ``video3d_tpu_torch/csrc`` (nvcc,
   sm_90a) and prints the build time;
3. holds each kernel (B1 cost volume, B2 horizontal sweeps, B3 downward
   sweeps + WTA, B4 speckle, B5 flow warp, B6 flow match, B7a/B7b
   attention) against its plain PyTorch twin on the card at the main
   path's shapes: two 1080p frames, 1920-wide eyes, D=64; the warp at
   1080x1920 with r = 16 and at 270x480 with r = 6, the match at 270x480;
   attention at DPT-large's (2, 16, 577, 64) in bf16 and f32 and at two
   other sequence lengths. B1, B2 and B4 must be bit-exact; B3 must have
   identical validity and disparity within 1e-5 (margin within rtol
   1e-6); B5 within 1e-5, B6 within 2e-4 px; B7 within 1e-5 in f32 and,
   in bf16, within 2^-7 |twin| + 2^-10 (about one bf16 ulp) on >= 99.9% of
   the outputs;
4. drives the stereo-only depth stage (``StereoDepthExtractor._run_batches``)
   over two batches of synthetic 1920x1080 SBS frames whose eyes differ by
   a known horizontal shift, writing PNG16 maps, and checks the launch
   counts, the valid fraction, the median disparity and one batch's maps
   against the plain path on the card; then drives the same stage with
   the flow-guided temporal smoother (``temporal_smooth="flow"``) over two
   batches of a panning clip, and checks the launch counts of B1-B6, the
   pass-through of frame 0, the disparity, the flow of the pan, and the
   first batch's smoothed maps against the same path run on the plain
   twins; then drives the DPT hybrid (``guidance="dpt"``: DPT-large at
   full width and depth with random bf16 weights from seed 0, keyframes
   every 4th frame, hole fill, SSI alignment, confidence-trust blend)
   over two batches of 8, and checks the launch counts (B7: 24 per batch,
   one per ViT layer over the batch's two keyframes), the hole fill,
   finite values, the median disparity and batch 0's maps against the
   same path with every kernel (B1-B4, B7) swapped for its twin;
5. times each kernel and twin with CUDA events, the stage's frames/s with
   and without the flow smoother and with DPT guidance at K=4 and K=1,
   the DPT-large forward per keyframe, and the smoother alone per frame.

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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sbs_frames(n: int, seed: int) -> np.ndarray:
    """(n, 1080, 1920, 3) uint8 SBS frames: random texture at a 2-pixel
    grain; the right eye is the left eye shifted left by SHIFT_EYE."""
    rng = np.random.default_rng(seed)
    w_eye = W_SBS // 2
    base = rng.integers(0, 256, (n, H // 2, (w_eye + SHIFT_EYE) // 2 + 1, 3),
                        dtype=np.uint8)
    base = np.repeat(np.repeat(base, 2, axis=1), 2, axis=2)
    base = base[:, :H, :w_eye + SHIFT_EYE]
    left = base[:, :, :w_eye]
    right = base[:, :, SHIFT_EYE:SHIFT_EYE + w_eye]
    return np.ascontiguousarray(np.concatenate([left, right], axis=2))


def pan_frames(n: int, seed: int) -> np.ndarray:
    """(n, 1080, 1920, 3) uint8 SBS frames of one random texture (2-pixel
    grain) panning PAN_EYE eye pixels per frame: frame t's left eye is
    base[:, PAN_EYE*t:], so cur(x) = prev(x + PAN_EYE) (backward flow
    +PAN_EYE). The right eye is the left shifted by SHIFT_EYE, as in
    :func:`sbs_frames`."""
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
        (sgm, "down_sweeps_wta", sgm.down_sweeps_wta_plain),
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
    sys.path.insert(0, str(ROOT))
    from video3d_tpu_torch.kernels import (_build, attention, costvol,
                                           flowmatch, sgm, speckle, warp)
    from video3d_tpu_torch.models.dpt import random_dpt_guidance
    from video3d_tpu_torch.ops.attention import attention_plain
    from video3d_tpu_torch.ops.fill import fill_holes
    from video3d_tpu_torch.ops.flow import (FlowEMAParams, estimate_flow_fast,
                                            flow_ema_scan, flow_match_plain,
                                            warp_bilinear_shifts_plain)
    from video3d_tpu_torch.ops.image import resize2d, rgb_to_gray
    from video3d_tpu_torch.ops.speckle import speckle_filter_device
    from video3d_tpu_torch.ops.stereo import (INVALID, SGBMParams,
                                              sgbm_disparity)
    from video3d_tpu_torch.parallel.temporal import TemporalFlowEMAStream
    from video3d_tpu_torch.stages.depth import (StereoDepthExtractor,
                                                depth_batch_pipeline,
                                                disparity_to_uint16,
                                                gray_pair, guidance_blend,
                                                rgb_eyes)

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
    from video3d_tpu.core import _native

    print(f"cv2: {cv2_version}; native PNG writer: "
          f"{'yes' if _native.lib() is not None else 'no'}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.1f} s) "
          f"-> {lib_path.relative_to(ROOT)}")

    # -- 3. each kernel against its twin at the main path's shapes ---------
    p = SGBMParams()
    inv = 2.0 * p.prefilter_cap
    frames2 = torch.from_numpy(sbs_frames(B, SEED)).to(dev)
    gl, gr = gray_pair(frames2)
    check(gl.shape == (B, H, W_SBS), f"gray shape {tuple(gl.shape)}")
    rows = []

    cost, lf = costvol.cost_volume(gl, gr, p, inv, return_filtered_left=True)
    check(cost.shape == (B, H, W_SBS, D), f"cost shape {tuple(cost.shape)}")
    cost_p, lf_p = costvol.cost_volume_plain(gl, gr, p, inv, True)
    torch.cuda.synchronize()
    err = (cost.int() - cost_p.int()).abs().max().item()
    check(err == 0 and torch.equal(lf, lf_p), f"B1 differs from twin: {err}")
    at_1080 = "ms/frame at 1080p D=64"
    rows.append(dict(
        at=at_1080, name="B1 cost_volume", source="video3d_tpu_torch/csrc/costvol.cu",
        replaces="video3d_tpu/kernels/costvol.py:394", max_abs_err=err,
        ms=cuda_ms(lambda: costvol.cost_volume(gl, gr, p, inv), 5) / B,
        plain_ms=cuda_ms(lambda: costvol.cost_volume_plain(gl, gr, p, inv),
                         1) / B))
    del cost_p, lf_p

    acc = sgm.horizontal_sweeps(cost, p)
    acc_p = sgm.horizontal_sweeps_plain(cost, p)
    torch.cuda.synchronize()
    err = (acc.int() - acc_p.int()).abs().max().item()
    check(err == 0, f"B2 differs from twin: {err}")
    rows.append(dict(
        at=at_1080, name="B2 horizontal_sweeps", source="video3d_tpu_torch/csrc/sgm.cu",
        replaces="video3d_tpu/kernels/sgm.py:617", max_abs_err=err,
        ms=cuda_ms(lambda: sgm.horizontal_sweeps(cost, p), 5) / B,
        plain_ms=cuda_ms(lambda: sgm.horizontal_sweeps_plain(cost, p),
                         1) / B))
    del acc_p

    disp_p, m_p = sgm.down_sweeps_wta_plain(cost, acc, p, True)
    acc_scratch = acc.clone()
    disp, m = sgm.down_sweeps_wta(cost, acc_scratch, p, True)
    torch.cuda.synchronize()
    err = (disp - disp_p).abs().max().item()
    check(torch.equal(disp >= 0, disp_p >= 0), "B3 validity differs")
    check(err <= 1e-5, f"B3 disparity differs from twin: {err}")
    check(torch.allclose(m, m_p, rtol=1e-6, atol=0.0), "B3 margin differs")
    rows.append(dict(
        at=at_1080, name="B3 down_sweeps_wta", source="video3d_tpu_torch/csrc/sgm.cu",
        replaces="video3d_tpu/kernels/sgm.py:882", max_abs_err=err,
        # the kernel adds into its acc argument: time it on a scratch copy
        # (int16 wrap-around in the scratch does not change the work done)
        ms=cuda_ms(lambda: sgm.down_sweeps_wta(cost, acc_scratch, p), 5) / B,
        plain_ms=cuda_ms(lambda: sgm.down_sweeps_wta_plain(cost, acc, p),
                         1) / B))
    del disp_p, m_p, m, acc_scratch

    sp_args = (INVALID(p), float(p.speckle_range), p.speckle_window_size,
               (0.0, float(p.num_disparities)))
    sp = speckle.speckle_filter(disp, *sp_args)
    sp_p = speckle_filter_device(disp, *sp_args)
    torch.cuda.synchronize()
    err = (sp - sp_p).abs().max().item()
    check(torch.equal(sp, sp_p), f"B4 differs from twin: {err}")
    rows.append(dict(
        at=at_1080, name="B4 speckle_filter", source="video3d_tpu_torch/csrc/speckle.cu",
        replaces="video3d_tpu/kernels/speckle.py:159", max_abs_err=err,
        ms=cuda_ms(lambda: speckle.speckle_filter(disp, *sp_args), 10) / B,
        plain_ms=cuda_ms(lambda: speckle_filter_device(disp, *sp_args),
                         3) / B))
    del cost, acc, disp, sp, sp_p, frames2
    torch.cuda.empty_cache()

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
    rows.append(dict(
        at="ms/call, 1080x1920 r=16 (one per frame)", name="B5 warp",
        source="video3d_tpu_torch/csrc/warp.cu",
        replaces="video3d_tpu/kernels/warp.py:91",
        max_abs_err=max(b["err"] for b in b5), ms=b5[0]["ms"],
        plain_ms=b5[0]["plain_ms"]))

    # B6 at the finest flow level at flow_scale 4
    shape = (270, 480)
    cur, prev_w = plane(0, 255, shape), plane(0, 255, shape)
    fy, fx = plane(-3, 3, shape), plane(-3, 3, shape)
    got = flowmatch.flow_match(cur, prev_w, fy, fx, 2, 3, 2.0)
    want = flow_match_plain(cur, prev_w, fy, fx, 2, 3, 2.0)
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    check(err <= 2e-4, f"B6 differs from twin: {err}")
    rows.append(dict(
        at="ms/call at 270x480, search 2, radius 3, tau 2", name="B6 flow_match",
        source="video3d_tpu_torch/csrc/flowmatch.cu",
        replaces="video3d_tpu/kernels/flowmatch.py:122", max_abs_err=err,
        ms=cuda_ms(lambda: flowmatch.flow_match(cur, prev_w, fy, fx, 2, 3,
                                                2.0), 20),
        plain_ms=cuda_ms(lambda: flow_match_plain(cur, prev_w, fy, fx, 2, 3,
                                                  2.0), 3)))
    del img, fy, fx, got, want, cur, prev_w

    # B7a (8 heads per block) and B7b (one) at DPT-large's attention shape
    # (two keyframes, 16 heads, 577 tokens, head dim 64), in both dtypes,
    # and at two more sequence lengths; 577 is not a multiple of the
    # kernel's 64-key tile, nor are 130 and 1500
    b7 = {}
    for shape in ((2, 16, 577, 64), (1, 6, 130, 16), (1, 4, 1500, 32)):
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
                    bound = 2.0 ** -7 * want.abs() + 2.0 ** -10
                    frac = float((err <= bound).float().mean().item())
                    check(frac >= 0.999,
                          f"{name} bf16 vs twin at {shape}: {frac} in bound")
                key = (name, shape, dtype)
                b7[key] = dict(err=max_err, frac=frac)
                if shape[2] == 577:
                    b7[key]["ms"] = cuda_ms(fn, 20)
                    b7[key]["plain_ms"] = cuda_ms(
                        lambda: attention_plain(q, k, v, sm), 20)
                print(f"{name} attention {shape} {str(dtype)[6:]}: max |err| "
                      f"{max_err:.3e}, {frac:.6f} of outputs in bound"
                      + (f"; {b7[key]['ms']:.4f} ms/call vs plain "
                         f"{b7[key]['plain_ms']:.4f} on {card}"
                         if "ms" in b7[key] else ""))
    del q, k, v, want, got, err
    # one kernel and one launch count: the DPT path calls B7a's entry at
    # one head per block, B7b's setting
    for name, label, src_line, per_block in (
            ("B7a", "attention_multihead", 84, "8 heads per block"),
            ("B7b", "attention_oneblock", 116,
             "1 head per block (the DPT path's setting)")):
        key = (name, (2, 16, 577, 64), torch.bfloat16)
        rows.append(dict(
            at=f"ms/call at (2, 16, 577, 64) bf16 (one ViT layer, two "
               f"keyframes), {per_block}", name=f"{name} {label}",
            source="video3d_tpu_torch/csrc/attention.cu",
            replaces=f"video3d_tpu/kernels/attention.py:{src_line}",
            max_abs_err=max(e["err"] for kk, e in b7.items()
                            if kk[0] == name),
            ms=b7[key]["ms"], plain_ms=b7[key]["plain_ms"]))
    torch.cuda.empty_cache()
    for r in rows:
        print(f"{r['name']}: matches its twin (max |err| {r['max_abs_err']}); "
              f"{r['ms']:.4f} vs plain {r['plain_ms']:.4f} {r['at']} "
              f"on {card}")

    # -- 4. the main path ----------------------------------------------------
    def plain_depth(frames_np):
        """uint16 maps and left gray of the depth path on the plain twins."""
        x = torch.from_numpy(frames_np).to(dev)
        pgl, pgr = gray_pair(x)
        pcost = costvol.cost_volume_plain(pgl, pgr, p, inv)
        pdisp = sgm.down_sweeps_wta_plain(
            pcost, sgm.horizontal_sweeps_plain(pcost, p), p)
        pdisp = speckle_filter_device(pdisp, *sp_args)
        return disparity_to_uint16(pdisp, p.num_disparities), pgl

    def counts(reset: bool = False) -> list:
        mods = ((costvol, "launches"), (sgm, "sweep_launches"),
                (sgm, "wta_launches"), (speckle, "launches"),
                (warp, "launches"), (flowmatch, "launches"),
                (attention, "launches"))
        if reset:
            for mod, attr in mods:
                setattr(mod, attr, 0)
        return [getattr(mod, attr) for mod, attr in mods]

    def read_maps(cache, n):
        from video3d_tpu.core import list_depth_frames, load_depth_png16

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
        launches = counts()[:4]
        print(f"main path: {n} frames in batches of {batch}, "
              f"{run_s:.3f} s incl. first-batch warm-up and PNG writes; "
              f"launches B1..B4 = {launches}")
        for r, k in zip(rows, launches):
            r["launches"] = k
        check(n == 2 * batch, f"wrote {n} frames")
        check(all(k > 0 for k in launches), f"a kernel never ran: {launches}")
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
        flaunches = counts()
        print(f"flow path: {n_flow} frames in batches of {fbatch}, "
              f"{flow_s:.3f} s "
              f"incl. first-batch warm-up and PNG writes; launches B1..B6 = "
              f"{flaunches}")
        for r, k in zip(rows[4:6], flaunches[4:6]):
            r["launches"] = k
        check(n_flow == 2 * fbatch, f"wrote {n_flow} frames")
        check(all(k > 0 for k in flaunches[:6]),
              f"a kernel never ran on the flow path: {flaunches}")
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
        hlaunches = counts()
        print(f"hybrid path: {n_hyb} frames in batches of 8, K="
              f"{hext.guidance_every}, fill {hext.fill_holes}, blend "
              f"{hext.blend}, {hyb_s:.3f} s incl. first-batch warm-up and PNG "
              f"writes; launches B1..B7 = {hlaunches}")
        check(n_hyb == 16, f"wrote {n_hyb} frames")
        check(hlaunches[:4] == [2, 2, 2, 2] and hlaunches[4:6] == [0, 0],
              f"hybrid path launches {hlaunches}")
        check(hlaunches[6] == 2 * 24,
              f"B7 launches {hlaunches[6]}, expected 24 per batch")
        rows[6]["launches"] = rows[7]["launches"] = hlaunches[6]
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
            check(counts() == [0] * 7, f"twin run launched {counts()}")
        d = np.abs(tmaps - hmaps[:8].astype(np.int32))
        within = float((d <= 64).mean())
        print(f"hybrid batch 0 vs the twins: {float((d == 0).mean()):.6f} of "
              f"pixels equal, {within:.6f} within 64 uint16 units (1/16 px), "
              f"max |diff| {int(d.max())}")
        check(within >= 0.99, f"hybrid path vs twins: {within} within 64")
        del x0, left, right, hgl, hgr, disp, conf, filled, holes, blended
        torch.cuda.empty_cache()

        # -- 5. stage frames/s on the device (no PNG writes) ---------------
        xb = torch.from_numpy(batches[1][0]).to(dev)
        ms = cuda_ms(lambda: depth_batch_pipeline(xb), 3)
        fps = batch * 1000.0 / ms
        print(f"stage: {ms:.3f} ms per batch of {batch} = {fps:.2f} frames/s "
              f"(1080p SBS, stereo-only, device time) on {card}")
        print(f"main path incl. PNG writes: {n / run_s:.2f} frames/s on {card}")

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
            print(f"hybrid stage K={kev}: {ms_h:.3f} ms per batch of 8 = "
                  f"{8000.0 / ms_h:.2f} frames/s (stereo-only on the same "
                  f"batch {8000.0 / ms_stereo:.2f}; device time) on {card}")
        print(f"hybrid path incl. PNG writes: {n_hyb / hyb_s:.2f} frames/s on "
              f"{card}")
        del xh, x384, lh

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
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [dict(name=r["name"], route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=r["launches"],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"]) for r in rows]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
