"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the environment (torch, CUDA, nvcc, card name and power limit,
   TF32 flags, PNG writers available);
2. builds the port's CUDA kernels from ``video3d_tpu_torch/csrc`` (nvcc,
   sm_90a) and prints the build time;
3. holds each kernel (B1 cost volume, B2 horizontal sweeps, B3 downward
   sweeps + WTA, B4 speckle) against its plain PyTorch twin on the card at
   the main path's shapes: two 1080p frames, 1920-wide eyes, D=64. B1, B2
   and B4 must be bit-exact; B3 must have identical validity and disparity
   within 1e-5 (margin within rtol 1e-6);
4. drives the stereo-only depth stage (``StereoDepthExtractor._run_batches``)
   over two batches of synthetic 1920x1080 SBS frames whose eyes differ by
   a known horizontal shift, writing PNG16 maps, and checks the launch
   counts, the valid fraction, the median disparity and one batch's maps
   against the plain path on the card;
5. times each kernel and twin with CUDA events, and the stage's frames/s.

The second-to-last line is a JSON object of the kernels, preceded by the
card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. There is no CPU mode.
"""

from __future__ import annotations

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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    sys.path.insert(0, str(ROOT))
    from video3d_tpu_torch.kernels import _build, costvol, sgm, speckle
    from video3d_tpu_torch.ops.speckle import speckle_filter_device
    from video3d_tpu_torch.ops.stereo import INVALID, SGBMParams
    from video3d_tpu_torch.stages.depth import (StereoDepthExtractor,
                                                disparity_to_uint16,
                                                gray_pair)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    rows.append(dict(
        name="B1 cost_volume", source="video3d_tpu_torch/csrc/costvol.cu",
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
        name="B2 horizontal_sweeps", source="video3d_tpu_torch/csrc/sgm.cu",
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
        name="B3 down_sweeps_wta", source="video3d_tpu_torch/csrc/sgm.cu",
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
        name="B4 speckle_filter", source="video3d_tpu_torch/csrc/speckle.cu",
        replaces="video3d_tpu/kernels/speckle.py:159", max_abs_err=err,
        ms=cuda_ms(lambda: speckle.speckle_filter(disp, *sp_args), 10) / B,
        plain_ms=cuda_ms(lambda: speckle_filter_device(disp, *sp_args),
                         3) / B))
    del cost, acc, disp, sp, sp_p, frames2
    torch.cuda.empty_cache()
    for r in rows:
        print(f"{r['name']}: equal to twin (max |err| {r['max_abs_err']}); "
              f"{r['ms']:.3f} ms/frame vs plain {r['plain_ms']:.3f} ms/frame "
              f"at 1080p D=64 on {card}")

    # -- 4. the main path ----------------------------------------------------
    work = Path(tempfile.mkdtemp(prefix="v3d_smoke_"))
    try:
        ext = StereoDepthExtractor(work_dir=str(work), guidance="none",
                                   device=dev)
        batch = ext._auto_batch_size(H, W_SBS)
        batches = [(sbs_frames(batch, SEED + 1 + i), batch) for i in range(2)]
        cache = work / "depth_smoke"
        for mod, attr in ((costvol, "launches"), (sgm, "sweep_launches"),
                          (sgm, "wta_launches"), (speckle, "launches")):
            setattr(mod, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = ext._run_batches(batches, cache)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = [costvol.launches, sgm.sweep_launches, sgm.wta_launches,
                    speckle.launches]
        print(f"main path: {n} frames in batches of {batch}, "
              f"{run_s:.3f} s incl. first-batch warm-up and PNG writes; "
              f"launches B1..B4 = {launches}")
        for r, k in zip(rows, launches):
            r["launches"] = k
        check(n == 2 * batch, f"wrote {n} frames")
        check(all(k > 0 for k in launches), f"a kernel never ran: {launches}")

        from video3d_tpu.core import list_depth_frames, load_depth_png16

        files = list_depth_frames(cache)
        check(len(files) == n, f"{len(files)} PNGs for {n} frames")
        maps = np.stack([load_depth_png16(f) for f in files])
        check(maps.shape == (n, H, W_SBS) and maps.dtype == np.uint16,
              f"maps {maps.shape} {maps.dtype}")
        disp_px = maps.astype(np.float64) * (p.num_disparities / 65535.0)
        valid = maps > 0
        frac = float(valid.mean())
        med = float(np.median(disp_px[valid]))
        print(f"valid fraction {frac:.4f}; median disparity {med:.4f} px "
              f"(shift {2 * SHIFT_EYE} px)")
        check(0.5 < frac <= 1.0, f"valid fraction {frac}")
        check(abs(med - 2 * SHIFT_EYE) <= 0.5, f"median disparity {med}")

        # the first batch's maps against the plain path on the card
        x = torch.from_numpy(batches[0][0]).to(dev)
        pgl, pgr = gray_pair(x)
        pcost = costvol.cost_volume_plain(pgl, pgr, p, inv)
        pdisp = sgm.down_sweeps_wta_plain(
            pcost, sgm.horizontal_sweeps_plain(pcost, p), p)
        pdisp = speckle_filter_device(pdisp, *sp_args)
        plain_maps = disparity_to_uint16(pdisp, p.num_disparities).cpu()
        plain_maps = plain_maps.to(torch.int32).numpy()
        n_diff = int((plain_maps != maps[:batch].astype(np.int32)).sum())
        print(f"batch 0 uint16 maps vs plain path: {n_diff} pixels differ")
        check(n_diff == 0, "main path differs from the plain path")
        del x, pgl, pgr, pcost, pdisp
        torch.cuda.empty_cache()

        # -- 5. stage frames/s on the device (no PNG writes) ---------------
        from video3d_tpu_torch.stages.depth import depth_batch_pipeline

        xb = torch.from_numpy(batches[1][0]).to(dev)
        ms = cuda_ms(lambda: depth_batch_pipeline(xb), 3)
        fps = batch * 1000.0 / ms
        print(f"stage: {ms:.3f} ms per batch of {batch} = {fps:.2f} frames/s "
              f"(1080p SBS, stereo-only, device time) on {card}")
        print(f"main path incl. PNG writes: {n / run_s:.2f} frames/s on {card}")
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
