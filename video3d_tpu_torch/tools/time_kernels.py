"""Times of kernels B2, B8c and B4 at 1080p over batch sizes and band counts.

What ``chip_smoke.py`` does not time: B2 (both horizontal sweeps, int16
and f32 accumulator), B8c (both W-major horizontal sweeps on the
(B, D, W, H) volume, the same accumulators, in one launch and as a
forward and a reverse one-direction launch) and B4 (speckle vote
at the default 3 bands, and at 9 and 65 bands, where it counts with
per-column histograms) at batches of 1, 2, 4 and 8 frames of 1920x1080,
D=64, in ms per frame (CUDA events over back-to-back calls), B2's and
B8c's launch plans beside them. Prints the card's name and power limit
first.

Usage: ``python -m video3d_tpu_torch.tools.time_kernels [batch ...]`` on a
CUDA card.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from video3d_tpu_torch.kernels import costvol, sgm, speckle, wmajor
from video3d_tpu_torch.ops.stereo import (INVALID, SGBMParams,
                                          acc_dtype_for_params)
from video3d_tpu_torch.stages.depth import gray_pair
from video3d_tpu_torch.tools.profile_stage import sbs_batch


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds per call of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    batches = [int(a) for a in (sys.argv[1:] if argv is None else argv)]
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0])
    p, p8 = SGBMParams(), SGBMParams(num_paths=8)
    for nb in batches or [1, 2, 4, 8]:
        gl, gr = gray_pair(torch.from_numpy(sbs_batch(nb)).to("cuda"))
        cost = costvol.cost_volume(gl, gr, p, 2.0 * p.prefilter_cap)
        for name, pp in (("int16", p), ("f32", p8)):
            ms = cuda_ms(lambda: sgm.horizontal_sweeps(cost, pp)) / nb
            print(f"B2 {name} acc, batch {nb}: {ms:.4f} ms/frame; blocks "
                  f"per SM, SMs, blocks, rounds = {sgm.horizontal_plan}")
        cost_t = cost.permute(0, 3, 2, 1).contiguous()  # (B, D, W, H)
        # absent from trees before the two-direction entry, so the tool
        # times those too (their one-direction pair only)
        both = getattr(wmajor, "horizontal_sweeps_wmajor_kernel", None)
        for name, pp in (("int16", p), ("f32", p8)):
            adt = acc_dtype_for_params(cost.dtype, pp)
            acc_t = torch.empty(cost_t.shape, dtype=adt, device="cuda")

            def pair():
                wmajor.wmajor_sweep(cost_t, None, pp.p1, pp.p2, False, adt)
                wmajor.wmajor_sweep(cost_t, acc_t, pp.p1, pp.p2, True)

            ms = cuda_ms(pair, 3) / nb
            print(f"B8c {name} acc, batch {nb}, forward + reverse "
                  f"one-direction launches: {ms:.4f} ms/frame")
            if both is not None:
                ms = cuda_ms(lambda: both(cost_t, pp.p1, pp.p2, adt)) / nb
                print(f"B8c {name} acc, batch {nb}, both directions in one "
                      f"launch: {ms:.4f} ms/frame; blocks per SM, SMs, "
                      f"blocks, rounds, rows a tile, shared bytes = "
                      f"{wmajor.horizontal_plan}")
            del acc_t
        del cost_t
        disp = sgm.vertical_sweeps_wta(cost, sgm.horizontal_sweeps(cost, p),
                                       p)
        for max_diff in (32.0, 8.0, 1.0):
            ms = cuda_ms(lambda: speckle.speckle_filter(
                disp, INVALID(p), max_diff, p.speckle_window_size,
                (0.0, float(p.num_disparities))), 20) / nb
            print(f"B4 max_diff {max_diff:g} "
                  f"({int(p.num_disparities / max_diff) + 1} bands), batch "
                  f"{nb}: {ms:.4f} ms/frame")
        del cost, disp
    return 0


if __name__ == "__main__":
    sys.exit(main())
