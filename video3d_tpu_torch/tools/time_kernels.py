"""Times of the port's kernels, and of the paths that have no benchmark cell.

Usage: ``python -m video3d_tpu_torch.tools.time_kernels [word ...]
[batch ...]`` on a CUDA card; the card's name and power limit come first.

Kernel words, at 1080p half-SBS (eyes 1920 wide after the unsqueeze),
D = 64, at each batch (default 1, 2, 4 and 8): ``i1`` (gray only and with
the RGB eyes), ``b1``, ``b2`` and ``b3`` (5 paths, int16 accumulator; 8,
f32), ``b4`` (3 bands, and 9 and 65: per-column histograms), ``b8a`` (8
and 5 paths on the f32 and bf16 volume B1's over 3), ``b8b`` (each way and
the round trip, beside a ``clone``: the card's copy rate) and ``b8c``
(both directions in one launch); once, at their paths' shapes: ``b5``
(the public warp at 1080x1920 and 270x480; the EMA step at 1080x1920 from
a 270x480 guide, gate on), ``b6`` (the public match and the level step at
270x480), ``b7`` (B7a and B7b at (2, 16, 577, 64) and the K=1 hybrid's
(8, 16, 577, 64), bf16 and f32) and ``p`` (the six int16 probe ops). Each
prints its time (CUDA events over back-to-back calls; device time from
``torch.profiler`` where a call's host cost shows), its plain twin's and
the max |error| against it, the library call's where one PyTorch call
computes the same function (the dense product for I1,
``permute().contiguous()`` for B8b, SDPA for B7), its launches a call and
its bound: the least time to move its bytes once at the card's memory
rate and do its operations at the unit's peak, from
``benchmark/harness/work.py`` (B1-B4 counted as its ``matcher_work``).

Path words: ``upscale`` (each upsample to 2160x3840 per frame),
``smoother`` (the flow smoother alone per frame, and its device
operations), ``crestereo`` and ``dpt`` (one guide forward per keyframe,
and the guidance call with its resizes, beside the operations that the
guide's kind counts, ``benchmark/guides/<kind>.py work``). No tool of the
port times the stage: ``python3 benchmark/run.py --workload <cell>`` does.

``json`` prints one ``{"kernels": [...]}`` line, a row a kernel (alone, it
runs every kernel word at batches 2 and 8; rows at batch 8 end in "@8").
``digest`` prints a SHA-256 of B1-B4's outputs (the int16 cost, B2's sums
at 5 and 8 paths, B3's disparity and margin, B4's map), to show that two
trees give the same bits. ``PYTHONPATH=<other tree> python
video3d_tpu_torch/tools/time_kernels.py b3 digest 2 8`` runs another
checkout's kernels in the same call (one whose ``tools/card_checks.py``
has ``sbs_batch`` and ``profile_kernels``, which this tool imports).
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from video3d_tpu_torch.kernels import costvol, image, sgm, speckle, wmajor
from video3d_tpu_torch.ops.stereo import (INVALID, SGBMParams,
                                          acc_dtype_for_params, sgm_aggregate)
from video3d_tpu_torch.tools import probe_i16
from video3d_tpu_torch.tools.card_checks import (profile_kernels, sbs_batch,
                                                  smooth_plane)

H, W_EYE, D = 1080, 960, 64
# operations per element that benchmark/harness/work.py does not count,
# whatever implements them. I1 per output pixel: 3 channels x 8 taps x a
# multiply-add, BT.601's 5
I1_OPS = 3 * 8 * 2 + 5
# B5's warp per pixel: two passes of floor, two hats of 3, two products and
# a sum
WARP_OPS = 20
# B6's match per pixel: 25 candidates of separable 7x7 SADs and the
# softargmin update
MATCH_OPS = 25 * (2 * 7 + 6)
# B6's level step per pixel: the incoming flow's upsample (2 x 7) and clamp
# (2 x 2); the warp; per candidate (25) the difference, its magnitude, a
# running add and subtract each way and the area scale, then the minimum,
# the exponent's difference and scale, the exp and three products-and-sums
# of the softargmin; the radius-2 smoothing of the two residuals (running
# sums, 4 each), its division and the add
LEVEL_OPS = 2 * 7 + 2 * 2 + 2 * 10 + 25 * (7 + 1 + 3 + 6) + 2 * (4 + 2)
# B5's EMA step per full-resolution pixel: three upsamples (flow y, x and
# alpha, 7 each), the warp, |depth - warp| (2), the radius-2 box (running
# sums, 4) and its division, the gate (6) and the blend (4); per guide
# pixel: the warp, |g - warp| (2), the box (4) and its division, alpha (4)
EMA_OPS = 3 * 7 + WARP_OPS + 2 + 4 + 1 + 6 + 4
GUIDE_OPS = WARP_OPS + 2 + 4 + 1 + 4
# P per element: add 1, add+sub 2, the column compare and select 2, the
# cast 5, the roll's casts 2, the halving 3
P_OPS = 15


def cuda_ms(fn, reps: int = 10, warm: bool = True) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps``
    back-to-back calls (CUDA events), after a warm-up call."""
    if warm:
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


def event_times(fn, reps: int) -> list:
    """Device milliseconds of each of ``reps`` calls of ``fn`` (CUDA
    events around each call, synchronised), after one warm-up call."""
    fn()
    return [cuda_ms(fn, 1, warm=False) for _ in range(reps)]


def spread(times) -> str:
    """'median (min-max)' of a list of milliseconds."""
    return (f"{float(np.median(times)):.4f} ms (spread {min(times):.4f}-"
            f"{max(times):.4f}, {len(times)} runs)")


def device_ms(fn, reps: int = 10):
    """Mean device milliseconds per call of ``fn``: per kernel its mean
    time a record times its launches a call (rounded: a trace has been
    seen to drop a record), or None when the trace holds no device time."""
    _, per = profile_kernels(fn, reps)
    total = sum(ms / n * round(n) for n, ms in per.values() if n)
    return total if total > 0 else None


def print_top(per: dict, top: int = 8) -> None:
    """The ``top`` kernels of :func:`profile_kernels` by device time."""
    for name, (n, ms) in sorted(per.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {ms:8.4f} ms  {n:5.1f} x  {name[:100]}")


def _dev(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def bound(nbytes: float, ops: float = 0.0, unit: str = "f32") -> tuple:
    """(ms, "bytes" | "operations"): the least time the card could take
    (``benchmark/harness/work.py least_ms``) and which side bounds it."""
    from benchmark.harness import work

    ms = work.least_ms(nbytes, ops, unit)
    return ms, ("bytes" if nbytes / work.HBM_BYTES_S * 1e3 >= ms
                else "operations")


def counted(mod, attr: str, fn) -> int:
    """Launches a call of ``fn`` by the wrapper counter ``mod.attr``."""
    n = getattr(mod, attr)
    fn()
    return getattr(mod, attr) - n


def max_err(got, want) -> float:
    if isinstance(got, (tuple, list)):
        return max(max_err(g, w) for g, w in zip(got, want))
    return (got.double() - want.double()).abs().max().item()


def measure(rows: dict, key: str, what: tuple, at: str, fn, plain,
            work: tuple, counter: tuple, nb: int = 1, reps: int = 10,
            plain_reps: int = 1, library=None, device: bool = False) -> None:
    """Times ``fn`` (``reps`` back-to-back calls after a warm-up) and its
    twin ``plain`` (``plain_reps`` calls after the one that gives the
    error), per frame of ``nb``, and ``library``; counts its launches a
    call by the wrapper counter ``counter`` (module, name); with
    ``device`` its device time too. Records the row ``key`` of the json
    line and prints it. ``what``: (name, source under
    ``video3d_tpu_torch/csrc``, the TPU kernel it replaces); ``work``: the
    arguments of :func:`bound` a call."""
    want = plain()  # first: a kernel may add into its input (B3)
    err = max_err(fn(), want)
    del want
    plain_ms = cuda_ms(plain, plain_reps, warm=False) / nb
    ms = cuda_ms(fn, reps) / nb
    lib_ms = None if library is None else cuda_ms(library, reps) / nb
    dev = _per(device_ms(fn), nb) if device else None
    b_ms, by = bound(*work)
    rows[key] = dict(name=what[0], route="cuda",
                     source=f"video3d_tpu_torch/csrc/{what[1]}",
                     replaces=what[2], launches=counted(*counter, fn),
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=by, library_ms=lib_ms)
    print(f"{key} {what[0]}: {ms:.4f} {at}"
          + ("" if dev is None else f", device {dev:.4f}")
          + f"; twin {plain_ms:.4f}; library "
          + ("none" if lib_ms is None else f"{lib_ms:.4f}")
          + f"; bound {b_ms:.4f} ({by}); max |err| {err}; launches a call "
          f"{rows[key]['launches']}")


def _per(ms, n):
    return None if ms is None else ms / n


WORDS = ("i1", "b1", "b2", "b3", "b4", "b8a", "b8b", "b8c", "b5", "b6", "b7",
         "p")
PATHS = ("upscale", "smoother", "crestereo", "dpt")


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    batches = [int(a) for a in args if a.isdigit()]
    words = [a for a in args if not a.isdigit()]
    unknown = set(words) - set(WORDS + PATHS + ("json", "digest"))
    if unknown:
        print(f"time_kernels: unknown words {sorted(unknown)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    if words == ["json"]:
        words += WORDS
    words = words or list(WORDS)
    batches = batches or ([2, 8] if "json" in words else [1, 2, 4, 8])
    # f32 products (the twins, I1's library call) stay full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0])
    rows = {}
    p = SGBMParams()
    per_batch = {"i1": i1, "b1": b1, "b2": b2, "b3": b3, "b4": b4,
                 "b8a": b8a, "b8b": b8b, "b8c": b8c, "digest": digest}
    for nb in batches:
        frames = torch.from_numpy(sbs_batch(nb)).to("cuda")
        gl, gr = image.eyes_gray(frames, True)[:2]
        bt = SimpleNamespace(
            nb=nb, tag="" if nb == 2 else f"@{nb}", frames=frames, gl=gl,
            gr=gr, p=p, cost=costvol.cost_volume(gl, gr, p,
                                                 2.0 * p.prefilter_cap))
        for name, fn in per_batch.items():
            if name in words:
                fn(bt, rows)
        del bt, frames, gl, gr
        torch.cuda.empty_cache()
    once = {"b5": b5, "b6": b6, "b7": b7, "p": probe, "upscale": upscale,
            "smoother": smoother, "crestereo": crestereo, "dpt": dpt}
    for name, fn in once.items():
        if name in words:
            fn(rows)
    if "json" in words:
        print(json.dumps({"kernels": list(rows.values())}))
    return 0


def matcher_work(bt, kernel: str) -> tuple:
    """(bytes, operations) a frame of B1-B4 at 5 paths, int16 cost and
    accumulator: the benchmark's ``matcher_work``."""
    from benchmark.harness.work import matcher_work as work

    b, o = work(bt.nb, *bt.gl.shape[1:], D, False)[kernel]
    return b / bt.nb, o / bt.nb


def i1(bt, rows) -> None:
    """I1 gray only and with the RGB eyes, beside its twin (split, cast,
    dense f32 product, gray) and the unsqueeze's two f32 products alone."""
    from video3d_tpu_torch.ops.image import (_resample_matrix_on,
                                             eyes_gray_plain)

    x, nb = bt.frames, bt.nb
    _, h, w, _ = x.shape
    mat = _resample_matrix_on(w // 2, w, "lanczos4", x.device)
    eyes = [e.to(torch.float32).movedim(-1, 1)
            for e in torch.split(x, w // 2, dim=2)]
    for rgb in (False, True):
        n = 4 if rgb else 2
        measure(rows, ("I1-rgb" if rgb else "I1") + bt.tag,
                (f"I1 eyes_gray{' with RGB' * rgb}, batch {nb}", "image.cu",
                 "none (the dense matmul of video3d_tpu/ops/image.py "
                 "resize_width)"),
                f"ms/frame at 1080p half-SBS, batch {nb}",
                lambda: image.eyes_gray(x, True, rgb)[:n],
                lambda: eyes_gray_plain(x, True, rgb)[:n],
                # the SBS frame read once, the f32 eyes (gray, and RGB)
                # written once
                (h * w * 3 + 2 * h * w * 4 * (4 if rgb else 1),
                 2 * h * w * I1_OPS),
                (image, "launches"), nb, reps=20, device=True,
                library=lambda: [torch.matmul(e, mat) for e in eyes])


def _at(bt) -> str:
    return f"ms/frame at 1080p D=64, batch {bt.nb}"


def b1(bt, rows) -> None:
    """B1, which is also B1-i16 (the TPU's native-int16 variant computes
    the same function bit for bit, as costvol.cu does)."""
    gl, gr, p = bt.gl, bt.gr, bt.p
    inv = 2.0 * p.prefilter_cap
    for key, name, line in (("B1", "B1 cost_volume", 394),
                            ("B1-i16", "B1-i16 cost_volume (native int16 at "
                             "2x scale)", 196)):
        measure(rows, key + bt.tag,
                (f"{name}, batch {bt.nb}", "costvol.cu",
                 f"video3d_tpu/kernels/costvol.py:{line}"), _at(bt),
                lambda: costvol.cost_volume(gl, gr, p, inv),
                lambda: costvol.cost_volume_plain(gl, gr, p, inv),
                matcher_work(bt, "B1"), (costvol, "launches"), bt.nb)


def b2(bt, rows) -> None:
    """B2 at the int16 (5 paths) and the f32 (8 paths, MODE_HH)
    accumulator, with its launch plan."""
    cost = bt.cost
    for key, pp in (("B2", bt.p), ("B2-hh", bt.p.replace(num_paths=8))):
        b, o = matcher_work(bt, "B2")
        if pp.num_paths == 8:  # the f32 accumulator: 2 bytes more
            b += 2 * cost.numel() / bt.nb
        measure(rows, key + bt.tag,
                (f"B2 horizontal_sweeps{', f32 acc (MODE_HH)' * (key != 'B2')}"
                 f", batch {bt.nb}", "sgm.cu",
                 "video3d_tpu/kernels/sgm.py:617"), _at(bt),
                lambda: sgm.horizontal_sweeps(cost, pp),
                lambda: sgm.horizontal_sweeps_plain(cost, pp), (b, o),
                (sgm, "sweep_launches"), bt.nb)
        print(f"  plan: blocks per SM, SMs, blocks, rounds = "
              f"{sgm.horizontal_plan}")


def b3(bt, rows) -> None:
    """B3 at 5 paths (int16 accumulator, the packed route) and 8 (f32),
    with its route; its later calls run on their first's B2 sums (the
    8-path launches add into them: the same work)."""
    from benchmark.harness.work import SWEEP_OPS

    cost = bt.cost
    for key, pp in (("B3", bt.p), ("B3-hh", bt.p.replace(num_paths=8))):
        acc = sgm.horizontal_sweeps(cost, pp)
        b, o = matcher_work(bt, "B3")
        if pp.num_paths == 8:  # the f32 accumulator, three more directions
            b, o = b + 2 * cost.numel() / bt.nb, o + 3 * SWEEP_OPS * (
                cost.numel() / bt.nb)
        measure(rows, key + bt.tag,
                (("B3 vertical_sweeps_wta (MODE_SGBM, top-down)"
                  if key == "B3" else "B3 vertical_sweeps_wta, f32 acc "
                  "(MODE_HH, top-down then bottom-up)") + f", batch {bt.nb}",
                 "sgm.cu",
                 "video3d_tpu/kernels/sgm.py:882"), _at(bt),
                lambda: sgm.vertical_sweeps_wta(cost, acc, pp),
                lambda: sgm.vertical_sweeps_wta_plain(cost, acc, pp), (b, o),
                (sgm, "wta_launches"), bt.nb, device=True)
        route = getattr(sgm, "vertical_route", None)  # trees before it
        print(f"  route {route(cost.dtype, pp) if route else 'int32'}; "
              f"plan {sgm.vertical_plan}")
        del acc


def b4(bt, rows) -> None:
    """B4 at 3 bands (the defaults), then 9 and 65 bands."""
    from video3d_tpu_torch.ops.speckle import speckle_filter_device

    p = bt.p
    disp = sgm.vertical_sweeps_wta(bt.cost, sgm.horizontal_sweeps(bt.cost, p),
                                   p)
    for max_diff in (8.0, 1.0):
        ms = cuda_ms(lambda: speckle.speckle_filter(
            disp, INVALID(p), max_diff, p.speckle_window_size,
            (0.0, float(p.num_disparities))), 20) / bt.nb
        print(f"B4 {int(p.num_disparities / max_diff) + 1} bands, batch "
              f"{bt.nb}: {ms:.4f} ms/frame")
    args = (disp, INVALID(p), float(p.speckle_range), p.speckle_window_size,
            (0.0, float(p.num_disparities)))
    measure(rows, "B4" + bt.tag,
            (f"B4 speckle_filter, batch {bt.nb}", "speckle.cu",
             "video3d_tpu/kernels/speckle.py:159"), _at(bt),
            lambda: speckle.speckle_filter(*args),
            lambda: speckle_filter_device(*args), matcher_work(bt, "B4"),
            (speckle, "launches"), bt.nb, reps=20)


def b8a(bt, rows) -> None:
    """B8a at 8 and 5 paths on the f32 and bf16 volume ``cost / 3``, the
    default penalties over 3, beside the floor of its structure: the
    horizontal launch moves the cost twice and the f32 accumulator three
    times, each vertical launch the cost and the accumulator once and the
    total once."""
    from benchmark.harness.work import HBM_BYTES_S, SWEEP_OPS

    p, nb = bt.p, bt.nb
    vol = bt.cost.numel() / nb
    for paths in (8, 5):
        pa = SGBMParams(num_paths=paths, p1=p.p1 / 3, p2=p.p2 / 3)
        for dt in (torch.float32, torch.bfloat16):
            cf = (bt.cost.to(torch.float32) / 3).to(dt)
            cb = cf.element_size()
            t = "f32" if cb == 4 else "bf16"
            measure(rows, f"B8a-{t}{'-5' * (paths == 5)}{bt.tag}",
                    (f"B8a sgm_aggregate_pallas, {paths} paths, "
                     f"{str(dt)[6:]} cost, "
                     f"batch {nb}", "sgm.cu",
                     "video3d_tpu/kernels/sgm.py:119"), _at(bt),
                    lambda: sgm.sgm_aggregate_pallas(cf, paths, pa.p1, pa.p2),
                    lambda: sgm_aggregate(cf, pa),
                    # the cost read once, the f32 total written once
                    (vol * (cb + 4), paths * SWEEP_OPS * vol),
                    (sgm, "aggregate_launches"), nb, reps=5, device=True)
            steps = sgm.aggregate_plan[1]
            floor = ((2 * cb + 3 * 4) + steps * (cb + 2 * 4)) * vol
            print(f"  floor of its structure {floor / HBM_BYTES_S * 1e3:.4f} "
                  f"ms/frame ({floor / 1e6:.0f} MB); kernel launches a call, "
                  f"vertical steps = {sgm.aggregate_plan}")
            del cf


def b8b(bt, rows) -> None:
    """B8b each way and the round trip on the batch's int16 cost, beside
    ``permute().contiguous()`` and a ``clone``."""
    cost, nb = bt.cost, bt.nb
    h = cost.shape[1]
    cost_t = wmajor.transpose_to_wmajor(cost)
    nbytes = 4 * cost.numel() * cost.element_size() / nb  # a frame's trip
    for name, fn in (
            ("to", lambda: wmajor.transpose_to_wmajor(cost)),
            ("from", lambda: wmajor.transpose_from_wmajor(cost_t, h))):
        print(f"B8b {name}, batch {nb}: {cuda_ms(fn, 20) / nb:.4f} ms/frame, "
              f"device {_dev(_per(device_ms(fn), nb))}")
    measure(rows, "B8b" + bt.tag,
            (f"B8b transpose_to/from_wmajor, batch {nb}", "wmajor.cu",
             "video3d_tpu/kernels/sgm.py:254,279"),
            _at(bt) + f", to and from W-major (HP = {cost_t.shape[-1]})",
            lambda: wmajor.transpose_from_wmajor(
                wmajor.transpose_to_wmajor(cost), h),
            lambda: wmajor.transpose_from_wmajor_plain(
                wmajor.transpose_to_wmajor_plain(cost), h),
            # each way the int16 volume read once and written once; the
            # padding lanes are garbage by contract and not counted
            (nbytes,), (wmajor, "transpose_launches"), nb, reps=20,
            plain_reps=3, device=True,
            library=lambda: cost.permute(0, 3, 2, 1).contiguous().permute(
                0, 3, 2, 1).contiguous())
    print(f"  {nbytes / rows['B8b' + bt.tag]['ms'] / 1e9:.3f} TB/s of the "
          f"bound's {nbytes / 1e6:.0f} MB; plan {wmajor.transpose_plan}")
    # the card's copy rate on these bytes: a clone reads and writes the
    # volume once, half a round trip's bytes
    ms = cuda_ms(lambda: cost.clone(), 20) / nb
    print(f"copy of the int16 volume (clone), batch {nb}: {ms:.4f} "
          f"ms/frame = {nbytes / 2 / ms / 1e9:.3f} TB/s")
    del cost_t


def b8c(bt, rows) -> None:
    """B8c's two-direction entry on the (B, D, W, H) volume at the int16
    (5 paths) and the f32 (8 paths) accumulator."""
    from benchmark.harness.work import SWEEP_OPS

    cost_t = bt.cost.permute(0, 3, 2, 1).contiguous()
    vol = cost_t.numel() / bt.nb
    for key, pp in (("B8c", bt.p), ("B8c-f32", bt.p.replace(num_paths=8))):
        adt = acc_dtype_for_params(cost_t.dtype, pp)
        args = (cost_t, pp.p1, pp.p2, adt)
        measure(rows, key + bt.tag,
                (f"B8c horizontal_sweeps_wmajor_kernel (W-major "
                 f"horizontals), {str(adt)[6:]} acc, batch {bt.nb}",
                 "wmajor.cu", "video3d_tpu/kernels/sgm.py:391"),
                _at(bt) + ", both directions in one launch",
                lambda: wmajor.horizontal_sweeps_wmajor_kernel(*args),
                lambda: wmajor.horizontal_sweeps_wmajor_plain(*args),
                # the int16 cost read once, the total written once
                (vol * (2 + (4 if adt == torch.float32 else 2)),
                 2 * SWEEP_OPS * vol), (wmajor, "sweep_launches"), bt.nb)
        print(f"  plan: blocks per SM, SMs, blocks, rounds, rows a tile, "
              f"shared bytes = {wmajor.horizontal_plan}")
    del cost_t


def probe(rows) -> None:
    """P at the probe's shape: one call of all six ops, and six calls of
    one op each."""
    xs = probe_i16.probe_inputs("cuda")

    def six():
        for name, (_, n_in, _) in probe_i16.OPS.items():
            probe_i16.probe_op(name, *xs[:n_in])

    print(f"P six probe_op calls: {cuda_ms(six, 100):.4f} ms, device "
          f"{_dev(device_ms(six, 100))} ms")
    n_el = xs[0].numel()
    measure(rows, "P", ("P probe_i16 (six int16 toy ops, one launch)",
                        "probe_i16.cu", "tools/probe_i16.py:34"),
            "ms for all six ops at (8, 64, 256) int16, one call",
            lambda: probe_i16.probe_all(*xs),
            lambda: probe_i16.probe_all_plain(xs),
            # three inputs read once, six outputs written once
            ((3 + 6) * n_el * 2, P_OPS * n_el), (probe_i16, "launches"),
            reps=100, plain_reps=50, device=True)


def _planes(seed: int, lo: float, hi: float, *shape):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.uniform(lo, hi, shape).astype(
        np.float32)).to("cuda")


def b5(rows) -> None:
    """B5's public warp at the full-resolution depth warp (r = max_warp =
    16) and at the finest flow level at flow_scale 4 (270x480, r = 6); its
    EMA step at 1080x1920 from a 270x480 guide with the depth gate on."""
    from video3d_tpu_torch.kernels import warp
    from video3d_tpu_torch.ops.flow import (FlowEMAParams, ema_tail_plain,
                                            shift_edge,
                                            warp_bilinear_shifts_plain)

    what = ("B5 warp", "warp.cu", "video3d_tpu/kernels/warp.py:91")
    for (h, w), r in (((H, 2 * W_EYE), 16), ((270, 480), 6)):
        args = (_planes(0, -1, 1, h, w), _planes(1, -r - 1, r + 1, h, w),
                _planes(2, -r - 1, r + 1, h, w), r)
        measure(rows, "B5" + ("" if h == H else f"@{h}x{w}"), what,
                f"ms/call, {h}x{w} r={r}",
                lambda: warp.warp_bilinear_shifts(*args),
                lambda: warp_bilinear_shifts_plain(*args),
                # image and two flow planes in, one plane out
                (4 * h * w * 4, WARP_OPS * h * w), (warp, "launches"),
                reps=20, plain_reps=3)
    ema_p = FlowEMAParams()
    rq = max(1, int(round(ema_p.max_warp / 4)))
    hq, wq = 270, 480
    depth = smooth_plane(H, 2 * W_EYE, 4, "cuda", 1.0)
    g = smooth_plane(hq, wq, 5, "cuda")
    args = (ema_p, depth, (shift_edge(depth, 2, -3) + 0.05 * _planes(
        3, -1, 1, H, 2 * W_EYE)).contiguous(), g,
        shift_edge(g, 0, 1).contiguous(),
        _planes(6, -rq - 1, rq + 1, hq, wq),
        _planes(7, -rq - 1, rq + 1, hq, wq), rq)
    nf, nq = H * 2 * W_EYE, hq * wq
    measure(rows, "B5-ema", ("B5 ema_tail (EMA step, 3 launches)", *what[1:]),
            "ms/call at 1080x1920 from a 270x480 guide, gate on",
            lambda: warp.ema_tail(*args), lambda: ema_tail_plain(*args),
            # depth and prev_out in, the frame out; g, prev_g and the flow
            # in at guide scale
            ((3 * nf + 4 * nq) * 4, EMA_OPS * nf + GUIDE_OPS * nq),
            (warp, "launches"), reps=20, plain_reps=3, device=True)


def b6(rows) -> None:
    """B6's public match of an already warped frame at the finest flow
    level at flow_scale 4 (270x480, search 2, radius 3, tau 2), and its
    level step there with the warp inside, from a 135x240 flow."""
    from video3d_tpu_torch.kernels import flowmatch
    from video3d_tpu_torch.ops.flow import (flow_level_plain,
                                            flow_match_plain, shift_edge)

    h, w = 270, 480
    n6 = h * w
    src = ("flowmatch.cu", "video3d_tpu/kernels/flowmatch.py:122")
    args = (_planes(1, 0, 255, h, w), _planes(2, 0, 255, h, w),
            _planes(3, -3, 3, h, w), _planes(4, -3, 3, h, w), 2, 3, 2.0)
    measure(rows, "B6", ("B6 flow_match", *src),
            "ms/call at 270x480, search 2, radius 3, tau 2",
            lambda: flowmatch.flow_match(*args),
            lambda: flow_match_plain(*args),
            # four planes in, two out
            (6 * n6 * 4, MATCH_OPS * n6), (flowmatch, "launches"), reps=20,
            plain_reps=3)
    prev = smooth_plane(h, w, 3, "cuda")
    lvl = (shift_edge(prev, 1, -2).contiguous(), prev,
           _planes(5, -3, 3, 135, 240), _planes(6, -3, 3, 135, 240), 2, 3,
           2.0, 6)  # r = ceil(4 / 1) + 2: the finest level at flow_scale 4
    measure(rows, "B6-level", ("B6 flow_level (level step, warp inside)",
                               *src),
            "ms/call at 270x480 from a 135x240 flow, r 6",
            lambda: flowmatch.flow_level(*lvl),
            lambda: flow_level_plain(*lvl),
            # cur, prev and two coarse flow planes in, two flow planes out
            ((4 * n6 + 2 * 135 * 240) * 4, LEVEL_OPS * n6),
            (flowmatch, "launches"), reps=20, plain_reps=3, device=True)


def b7(rows) -> None:
    """B7a (``attention_multihead``, the DPT path's call) and B7b
    (``attention_oneblock``: the same launch) at one ViT layer's attention
    on two keyframes and on the K=1 hybrid's eight, bf16 and f32, beside
    SDPA; bf16 on the tensor cores."""
    from video3d_tpu_torch.kernels import attention
    from video3d_tpu_torch.ops.attention import attention_plain

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b in (2, 8):
        shape = (b, 16, 577, 64)
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (_planes(s, -2, 2, *shape).to(dt) for s in range(3))
            sm = 1.0 / shape[-1] ** 0.5
            print(f"SDPA {shape} {str(dt)[6:]}: device "
                  f"{_dev(device_ms(lambda: sdpa(q, k, v, scale=sm), 20))}")
            for key, entry, line in (
                    ("B7a", attention.attention_multihead, 84),
                    ("B7b", attention.attention_oneblock, 116)):
                measure(rows, key + "-f32" * (dt == torch.float32)
                        + ("" if b == 2 else f"@{b}"),
                        (f"{key} {entry.__name__}", "attention.cu",
                         f"video3d_tpu/kernels/attention.py:{line}"),
                        f"ms/call at {shape} {str(dt)[6:]}",
                        lambda: entry(q, k, v, sm),
                        lambda: attention_plain(q, k, v, sm),
                        # q, k, v in and o out; QK^T and PV
                        (4 * q.numel() * q.element_size(),
                         4 * b * 16 * 577 * 577 * 64,
                         "bf16" if dt == torch.bfloat16 else "f32"),
                        (attention, "launches"), reps=20, plain_reps=20,
                        device=True,
                        library=lambda: sdpa(q, k, v, scale=sm))


def _guide_work(config: str, h: int, w: int) -> dict:
    """{unit: operations} of one forward of ``config``'s guide on (h, w)
    eyes, as its kind's file counts them."""
    from benchmark.harness.registry import Registry

    reg = Registry()
    guide = reg.config(config)["guide"]
    return reg.guide(guide["kind"]).work(guide, h, w)


def _ops_ms(work: dict) -> float:
    """Each unit's operations at its peak, summed."""
    from benchmark.harness.work import PEAK_OPS_S

    return sum(ops / PEAK_OPS_S[u] for u, ops in work.items()) * 1e3


def _units(work: dict) -> str:
    return ", ".join(f"{ops / 1e9:.2f} G {u}" for u, ops in work.items())


def upscale(rows) -> None:
    """Each upsample per 2160x3840 frame on a resident batch of 4 from
    1080x1920 uint16 depth, guided by a 4K RGB frame, uint16 out."""
    from video3d_tpu_torch.ops import guided

    h4, w4 = 2 * H, 4 * W_EYE
    depth = torch.from_numpy(np.stack([
        smooth_plane(H, 2 * W_EYE, s, "cuda", 65535.0).cpu().numpy()
        for s in range(4)]).astype(np.uint16)).to("cuda")
    g4k = torch.from_numpy(sbs_batch(4, 0, h4, w4 // 2, 0)).to("cuda")
    ops = {
        "adaptive": lambda: guided.adaptive_upsample(
            depth, g4k, h4, w4, out_dtype="uint16"),
        "guided gray": lambda: guided.guided_upsample(
            depth, g4k, h4, w4, out_dtype="uint16"),
        "guided color": lambda: guided.guided_upsample(
            depth, g4k, h4, w4, guide_mode="color", out_dtype="uint16"),
        "plain": lambda: guided.plain_upsample(depth, h4, w4,
                                               out_dtype="uint16"),
    }
    # the depth and the guide read once, the uint16 frame written once
    b_ms, _ = bound(H * 2 * W_EYE * 2 + h4 * w4 * (3 + 2))
    for name, fn in ops.items():
        t = event_times(fn, 5)
        print(f"upscale {name}: {spread(t)} per batch of 4 = "
              f"{float(np.median(t)) / 4:.4f} ms per 2160x3840 frame; bound "
              f"{b_ms:.4f} (bytes)")
    n_ops, per = profile_kernels(ops["adaptive"], 2)
    print(f"upscale adaptive: {n_ops:.0f} device operations a batch of 4, "
          f"{sum(ms for _, ms in per.values()):.3f} ms; by device time:")
    print_top(per)


def smoother(rows) -> None:
    """The flow smoother alone, shaped as the JAX package's bench_smooth:
    T=8 uint16 1080p depth, 270x480 guide, one scan from frame 0."""
    from video3d_tpu_torch.ops.flow import FlowEMAParams, flow_ema_scan

    r = np.random.default_rng(2)
    sd = torch.from_numpy(r.integers(0, 65535, (8, H, 2 * W_EYE))
                          .astype(np.uint16)).to("cuda")
    sg = torch.from_numpy(r.integers(0, 255, (8, 270, 480))
                          .astype(np.float32)).to("cuda")

    def scan():
        flow_ema_scan(None, sd, sg, FlowEMAParams())

    ms = cuda_ms(scan, 3) / 8
    t0 = time.perf_counter()
    scan()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 8
    # the depth read and written once, the guide read once, a frame
    b_ms, _ = bound(H * 2 * W_EYE * 2 * 2 + 270 * 480 * 4)
    print(f"smoother alone: {ms:.4f} ms/frame CUDA events, {host_ms:.4f} "
          f"ms/frame host clock; bound {b_ms:.4f} (bytes)")
    n_dev, per = profile_kernels(scan, 1)
    print(f"smoother: {n_dev / 8:.2f} device operations a frame")
    for name, (k, _) in sorted(per.items(), key=lambda kv: -kv[1][0]):
        print(f"  {k / 8:6.2f} per frame  {name[:100]}")


def crestereo(rows) -> None:
    """One CREStereo-lite keyframe's forward at its half-resolution
    inference shape (bf16 convs) and the guidance call with its resizes
    at 1080x1920, beside its bound."""
    from video3d_tpu_torch.models.crestereo import load_crestereo_guidance
    from video3d_tpu_torch.ops.image import resize2d, rgb_eyes

    cfn = load_crestereo_guidance(device="cuda")
    lc, rc = rgb_eyes(torch.from_numpy(sbs_batch(1)).to("cuda"))
    hs, ws = H // 2, W_EYE
    ls, rs = (resize2d(e.movedim(-1, 1), hs, ws, "bilinear").movedim(1, -1)
              for e in (lc, rc))
    with torch.no_grad():
        t_fwd = event_times(lambda: cfn.module(ls, rs), 10)
        dev_fwd = device_ms(lambda: cfn.module(ls, rs), 5)
        n_ops, per = profile_kernels(lambda: cfn.module(ls, rs), 3)
    work = _guide_work("crestereo_hybrid", H, 2 * W_EYE)
    ops_ms = _ops_ms(work)
    b_ms = max(bound(2 * hs * ws * 3 * 4 + H * 2 * W_EYE * 4)[0], ops_ms)
    print(f"CREStereo forward, one keyframe at {hs}x{ws}: {spread(t_fwd)} "
          f"CUDA events, device {_dev(dev_fwd)}; guidance call with its "
          f"resizes {spread(event_times(lambda: cfn(lc, rc), 10))}; bound "
          f"{b_ms:.4f} ({_units(work)} at peak: {ops_ms:.4f})")
    print(f"CREStereo forward: {n_ops:.0f} device operations a keyframe; by "
          f"device time:")
    print_top(per)


def dpt(rows) -> None:
    """One DPT-large forward (random weights, bf16) per keyframe on a
    batch of 2 at 384x384, and the guidance call with its resizes on the
    two keyframes of a batch of 8, beside the bound."""
    from video3d_tpu_torch.models.dpt import random_dpt_guidance
    from video3d_tpu_torch.ops.image import rgb_eyes

    gfn = random_dpt_guidance(device="cuda")
    x384 = _planes(0, -1, 1, 2, 384, 384, 3).to(torch.bfloat16)
    with torch.no_grad():
        t_net = [t / 2 for t in event_times(lambda: gfn.module(x384), 5)]
        n_ops, per = profile_kernels(lambda: gfn.module(x384), 2)
    left, _ = rgb_eyes(torch.from_numpy(sbs_batch(8)).to("cuda"))
    t_gfn = [t / 2 for t in event_times(lambda: gfn(left[::4]), 5)]
    work = _guide_work("dpt_large_hybrid", H, 2 * W_EYE)
    print(f"DPT-large forward: {spread(t_net)} per keyframe (batch of 2 at "
          f"384x384, bf16); guidance call with its resizes {spread(t_gfn)} "
          f"per keyframe; bound {_ops_ms(work):.4f} ({_units(work)} at "
          f"peak)")
    print(f"DPT-large forward: {n_ops / 2:.0f} device operations a keyframe; "
          f"by device time (batch of 2):")
    print_top(per)


def digest(bt, rows) -> None:
    """SHA-256 of the bytes of B1-B4's outputs on the batch: the cost,
    B2's sums and B3's disparity and margin at 5 and 8 paths, B4's map."""
    cost, p, nb = bt.cost, bt.p, bt.nb
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


if __name__ == "__main__":
    sys.exit(main())
