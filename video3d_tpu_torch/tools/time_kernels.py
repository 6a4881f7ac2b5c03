"""Times of kernels B2, B8c, B4, B8a, B8b and P over batch sizes.

What ``chip_smoke.py`` does not time: B2 (both horizontal sweeps, int16
and f32 accumulator), B8c (both W-major horizontal sweeps on the
(B, D, W, H) volume, the same accumulators, in one launch and as a
forward and a reverse one-direction launch) and B4 (speckle vote
at the default 3 bands, and at 9 and 65 bands, where it counts with
per-column histograms) at batches of 1, 2, 4 and 8 frames of 1920x1080,
D=64, in ms per frame (CUDA events over back-to-back calls), B2's and
B8c's launch plans beside them; and B8a (``sgm_aggregate_pallas`` at 8
and 5 paths on the f32 and the bf16 cost volume, B1's volume over 3, with
the default penalties over 3) with its launches a call where the tree
records them; B8b (``transpose_to_wmajor`` and ``transpose_from_wmajor``
on the batch's int16 cost, HP = 1152, each way and the round trip, in
CUDA events and in device time from ``torch.profiler``, with the bytes a
second of the round trip's 4 x volume x 2 B, beside a ``clone`` of the
volume: the card's copy rate on the same bytes); and P, once (the six int16
probe ops at the probe's shape: six calls of ``probe_op``, and one call
of ``probe_all`` where the tree has it, event and device time a call).
``digest`` prints a SHA-256 of the outputs of B1-B4 (the int16 cost, B2's
sums at 5 and 8 paths, B3's disparity and margin, B4's map) instead of a
time, to show that two trees give the same bits. Prints the card's name
and power limit first. The script uses only entry points that trees
before the B8a redesign have (and ``probe_all`` where present), so
``PYTHONPATH=<other tree> python <this file> b8a b8b p digest 2`` runs
another checkout's kernels in the same call.

Usage: ``python -m video3d_tpu_torch.tools.time_kernels [kernel ...]
[batch ...]`` on a CUDA card; kernels are ``b2``, ``b8c``, ``b4``,
``b8a``, ``b8b``, ``p`` and ``digest`` (default: all but ``digest``),
batches default to 1, 2, 4 and 8.
"""

from __future__ import annotations

import hashlib
import subprocess
import sys

import numpy as np
import torch

from video3d_tpu_torch.kernels import costvol, sgm, speckle, wmajor
from video3d_tpu_torch.ops.stereo import (INVALID, SGBMParams,
                                          acc_dtype_for_params)
from video3d_tpu_torch.stages.depth import gray_pair
from video3d_tpu_torch.tools import probe_i16

HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate


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


def device_ms(fn, reps: int = 10):
    """Mean device milliseconds per call of ``fn`` from a ``torch.profiler``
    trace of ``reps`` calls after one warm-up: per kernel, its mean time a
    record times its launches a call (rounded: a trace has been seen to
    drop a record), or None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total / e.count * round(e.count / reps)
                   for e in prof.key_averages() if e.count)
    return total_us / 1e3 if total_us > 0 else None


def _dev(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


KERNELS = ("b2", "b8c", "b4", "b8a", "b8b", "p", "digest")


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    batches = [int(a) for a in args if a.isdigit()]
    kernels = [a for a in args if not a.isdigit()] or list(KERNELS[:-1])
    unknown = set(kernels) - set(KERNELS)
    if unknown:
        print(f"time_kernels: unknown kernels {sorted(unknown)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0])
    p = SGBMParams()
    if "p" in kernels:
        probe()
    timers = {"b2": b2, "b8a": b8a, "b8c": b8c, "b4": b4, "b8b": b8b,
              "digest": digest}
    for nb in batches or [1, 2, 4, 8]:
        gl, gr = gray_pair(torch.from_numpy(sbs_batch(nb)).to("cuda"))
        cost = costvol.cost_volume(gl, gr, p, 2.0 * p.prefilter_cap)
        for name in timers:
            if name in kernels:
                timers[name](cost, p, nb)
        del cost
    return 0


def b2(cost, p, nb: int) -> None:
    """B2 at the int16 (5 paths) and the f32 (8 paths) accumulator."""
    for name, pp in (("int16", p), ("f32", p.replace(num_paths=8))):
        ms = cuda_ms(lambda: sgm.horizontal_sweeps(cost, pp)) / nb
        print(f"B2 {name} acc, batch {nb}: {ms:.4f} ms/frame; blocks "
              f"per SM, SMs, blocks, rounds = {sgm.horizontal_plan}")


def b8a(cost, p, nb: int) -> None:
    """B8a at 8 and 5 paths on the f32 and bf16 volume ``cost / 3``."""
    for paths in (8, 5):
        for dt in (torch.float32, torch.bfloat16):
            cf = (cost.to(torch.float32) / 3).to(dt)
            args = (cf, paths, p.p1 / 3, p.p2 / 3)
            ms = cuda_ms(lambda: sgm.sgm_aggregate_pallas(*args), 5) / nb
            print(f"B8a {paths} paths, {str(dt)[6:]} cost, batch {nb}: "
                  f"{ms:.4f} ms/frame; launches a call, vertical steps = "
                  f"{getattr(sgm, 'aggregate_plan', None)}")
            del cf


def b8c(cost, p, nb: int) -> None:
    """B8c's two-direction entry and its one-direction pair, both
    accumulators."""
    cost_t = cost.permute(0, 3, 2, 1).contiguous()  # (B, D, W, H)
    # absent from trees before the two-direction entry, so the tool
    # times those too (their one-direction pair only)
    both = getattr(wmajor, "horizontal_sweeps_wmajor_kernel", None)
    for name, pp in (("int16", p), ("f32", p.replace(num_paths=8))):
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


def b8b(cost, p, nb: int) -> None:
    """B8b each way and the round trip on the batch's int16 cost."""
    h = cost.shape[1]
    cost_t = wmajor.transpose_to_wmajor(cost)
    nbytes = 4 * cost.numel() * cost.element_size() / nb  # a frame's trip
    for name, fn in (
            ("to", lambda: wmajor.transpose_to_wmajor(cost)),
            ("from", lambda: wmajor.transpose_from_wmajor(cost_t, h)),
            ("to + from", lambda: wmajor.transpose_from_wmajor(
                wmajor.transpose_to_wmajor(cost), h))):
        ms = cuda_ms(fn, 20) / nb
        dev = device_ms(fn)
        dev = None if dev is None else dev / nb
        rate = ("" if name != "to + from" else
                f"; {nbytes / ms / 1e9:.3f} TB/s of the bound's "
                f"{nbytes / 1e6:.0f} MB (bound "
                f"{nbytes / HBM_BYTES_S * 1e3:.4f} ms)")
        print(f"B8b {name}, batch {nb}: {ms:.4f} ms/frame, device "
              f"{_dev(dev)}{rate}; plan "
              f"{getattr(wmajor, 'transpose_plan', None)}")
    # the card's copy rate on these bytes: one device-to-device copy of
    # the volume reads and writes it once, half a round trip's bytes
    ms = cuda_ms(lambda: cost.clone(), 20) / nb
    print(f"copy of the int16 volume (clone), batch {nb}: {ms:.4f} "
          f"ms/frame = {nbytes / 2 / ms / 1e9:.3f} TB/s")
    del cost_t


def probe() -> None:
    """P at the probe's shape: six one-op calls, and one call of all six
    where the tree has ``probe_all``."""
    xs = probe_i16.probe_inputs("cuda")
    ops = list(probe_i16.OPS.items())

    def six():
        for name, (_, n_in, _) in ops:
            probe_i16.probe_op(name, *xs[:n_in])

    n = probe_i16.launches
    six()
    per = probe_i16.launches - n
    print(f"P six probe_op calls: {cuda_ms(six, 100):.4f} ms, device "
          f"{_dev(device_ms(six, 100))} ms ({per} launches)")
    probe_all = getattr(probe_i16, "probe_all", None)
    if probe_all is not None:
        n = probe_i16.launches
        probe_all(*xs)
        per = probe_i16.launches - n
        print(f"P one probe_all call: "
              f"{cuda_ms(lambda: probe_all(*xs), 100):.4f} ms, device "
              f"{_dev(device_ms(lambda: probe_all(*xs), 100))} ms ({per} "
              f"launch)")


def digest(cost, p, nb: int) -> None:
    """SHA-256 of the bytes of B1-B4's outputs on the batch: the cost,
    B2's sums and B3's disparity and margin at 5 and 8 paths, B4's map."""
    h = hashlib.sha256()

    def add(t):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())

    add(cost)
    for pp in (p, p.replace(num_paths=8)):
        acc = sgm.horizontal_sweeps(cost, pp)
        add(acc)
        disp, margin = sgm.vertical_sweeps_wta(cost, acc, pp, True)
        add(disp)
        add(margin)
    add(speckle.speckle_filter(disp, INVALID(p), float(p.speckle_range),
                               p.speckle_window_size,
                               (0.0, float(p.num_disparities))))
    print(f"B1-B4 outputs, batch {nb}: sha256 {h.hexdigest()}")


def b4(cost, p, nb: int) -> None:
    """B4 at 3, 9 and 65 bands on the batch's disparity."""
    disp = sgm.vertical_sweeps_wta(cost, sgm.horizontal_sweeps(cost, p), p)
    for max_diff in (32.0, 8.0, 1.0):
        ms = cuda_ms(lambda: speckle.speckle_filter(
            disp, INVALID(p), max_diff, p.speckle_window_size,
            (0.0, float(p.num_disparities))), 20) / nb
        print(f"B4 max_diff {max_diff:g} "
              f"({int(p.num_disparities / max_diff) + 1} bands), batch "
              f"{nb}: {ms:.4f} ms/frame")


if __name__ == "__main__":
    sys.exit(main())
