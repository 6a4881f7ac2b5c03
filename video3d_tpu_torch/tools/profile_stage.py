"""Where the depth stage's device time goes, kernel by kernel.

Runs :func:`video3d_tpu_torch.stages.depth.depth_batch_pipeline` on a
synthetic 1080p SBS batch (random texture at a 2-pixel grain, the right
eye the left shifted by 8 eye pixels: 16 px of disparity after the
unsqueeze), warms up, and profiles ``--reps`` calls with
``torch.profiler``. Prints the card's name and power limit, the wall time
per batch, the device's busy time per batch (the union of its kernel and
copy intervals) and its share of the wall time, then every kernel by
device time per batch, and a last JSON line of the same. With
``--temporal-smooth flow`` each call also pushes the batch's depth and
guide through the flow smoother's stream (``TemporalFlowEMAStream``), as
the stage with ``temporal_smooth="flow"`` does.

Usage: ``python -m video3d_tpu_torch.tools.profile_stage [--paths 8]
[--route legacy|xla|mxu] [--temporal-smooth none|flow] [--batch 8]
[--reps 3]`` on a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from video3d_tpu_torch.ops.stereo import HORIZONTAL_ROUTES, SGBMParams
from video3d_tpu_torch.parallel.temporal import TemporalFlowEMAStream
from video3d_tpu_torch.stages.depth import depth_batch_pipeline


def sbs_batch(n: int, seed: int = 0, h: int = 1080, w_eye: int = 960,
              shift: int = 8) -> np.ndarray:
    """(n, h, 2 * w_eye, 3) uint8 SBS frames of random 2-pixel-grain
    texture; the right eye is the left shifted left by ``shift``. The
    smoke's stereo, hybrid and MODE_HH frames are these too."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, -(-h // 2), (w_eye + shift) // 2 + 1, 3),
                        dtype=np.uint8)
    base = np.repeat(np.repeat(base, 2, axis=1), 2, axis=2)
    base = base[:, :h, :w_eye + shift]
    return np.ascontiguousarray(np.concatenate(
        [base[:, :, :w_eye], base[:, :, shift:shift + w_eye]], axis=2))


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def profile_stage(frames: torch.Tensor, params: SGBMParams,
                  route: str = "legacy", reps: int = 3,
                  smooth: str = "none") -> dict:
    """Profile ``reps`` calls of the stage on ``frames`` (already on the
    card) after one warm-up call (which seeds the smoother's carry);
    times per batch in ms."""
    from torch.profiler import ProfilerActivity, profile

    stream = TemporalFlowEMAStream()

    def run():
        if smooth == "none":
            return depth_batch_pipeline(frames, params=params,
                                        horizontal_route=route)
        depth, guide = depth_batch_pipeline(
            frames, params=params, horizontal_route=route, return_guide=True)
        return stream.push(depth, guide)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    per_name = defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        intervals.append((start, end))
        per_name[e.name][0] += (end - start) / 1e3 / reps
        per_name[e.name][1] += 1
    busy_ms = _busy_us(intervals) / 1e3 / reps
    kernels = sorted(((n, ms, c / reps) for n, (ms, c) in per_name.items()),
                     key=lambda k: -k[1])
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms if wall_ms else 0.0,
                kernels=kernels)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", type=int, default=5, choices=(2, 4, 5, 8))
    ap.add_argument("--route", default="legacy", choices=HORIZONTAL_ROUTES)
    ap.add_argument("--temporal-smooth", default="none",
                    choices=("none", "flow"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_stage: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    frames = torch.from_numpy(sbs_batch(args.batch)).to("cuda")
    res = profile_stage(frames, SGBMParams(num_paths=args.paths),
                        args.route, args.reps, args.temporal_smooth)
    print(f"card: {card}")
    print(f"stage, {args.paths} paths, route {args.route}, smoother "
          f"{args.temporal_smooth}, batch "
          f"{args.batch}: {res['wall_ms']:.3f} ms wall per batch under the "
          f"profiler, device busy {res['busy_ms']:.3f} ms "
          f"({100 * res['busy_share']:.1f}%)")
    for name, ms, calls in res["kernels"]:
        print(f"  {ms:9.3f} ms {100 * ms / res['busy_ms']:6.2f}% "
              f"{calls:6.1f} calls  {name[:110]}")
    print(json.dumps(dict(res, paths=args.paths, route=args.route,
                          smooth=args.temporal_smooth, batch=args.batch,
                          card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
