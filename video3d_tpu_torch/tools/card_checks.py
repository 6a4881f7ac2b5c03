"""Every CUDA kernel of the port against its plain twin: one case list and
one ``check_*`` function a kernel, run on the card by
``tests/test_torch_card.py``; a function raises ``AssertionError`` on a
mismatch.

A list holds the shapes that stress what the main path does not, then the
main path's own, appended (the CPU tests slice the first cases of
``FLOW_LEVEL_CASES`` and ``EMA_CASES``): 1080p half-SBS eyes (1920 wide
after the unsqueeze) at D = 64 and batches 2 and 8 for B1-B4 (5 paths: the
int16 accumulator and B3's packed route; 8: the f32 one), I1 and B8a-c;
DPT-large's attention for B7; the flow path's planes for B5 and B6. The
others: widths off a block's strip of columns, heights off B1's ring and
segments, D from one lane-run to four and ones no vector width divides,
``min_disparity`` 3, other blocks, batches that make B3 and B8a take their
wider blocks or run in two chunks, every SGM mode with and without the
margin, B3's packed route on random and extreme costs and the largest P2
it admits, B4 from 2 bands to one a disparity (both counting schemes), B7
sequence lengths off its 64-key tile, B6's level step along whole
pyramids and B5's EMA step with the gate on and off, B8c's entries on all
three type pairs up to the W-major route's padded rows, B8b and P from
aligned storage and from storage one element past it. Beyond the twin:
B8a's launches a call are those of its plan and of a ``torch.profiler``
trace; B8c's two-direction entry on an int16 cost equals its
one-direction pair and B2's sums; B8b equals the permute; B5's EMA step,
B6's level step, B8a-c and I1 give the same bits on a second run.

The frames, planes and traces that these checks, the path tests of
``tests/test_torch_card_paths.py`` and ``time_kernels`` share live here
too: ``sbs_batch``, ``smooth_plane`` and ``profile_kernels``.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from video3d_tpu_torch.kernels import (agcl, attention, blend, costvol,
                                       flowmatch, image, sgm, speckle, warp,
                                       wmajor)
from video3d_tpu_torch.ops import flow, stereo
from video3d_tpu_torch.ops.attention import attention_plain
from video3d_tpu_torch.ops.fill import fill_holes
from video3d_tpu_torch.ops.image import eyes_gray_plain, resize2d
from video3d_tpu_torch.ops.speckle import speckle_filter_device
from video3d_tpu_torch.ops.stereo import SGBMParams, sgm_aggregate
from video3d_tpu_torch.tools import probe_i16


def sbs_batch(n: int, seed: int = 0, h: int = 1080, w_eye: int = 960,
              shift: int = 8) -> np.ndarray:
    """(n, h, 2 * w_eye, 3) uint8 SBS frames of random 2-pixel-grain
    texture; the right eye is the left shifted left by ``shift``. The card
    tests' stereo, hybrid and MODE_HH frames are these too, and the
    frames ``time_kernels`` times."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, -(-h // 2), (w_eye + shift) // 2 + 1, 3),
                        dtype=np.uint8)
    base = np.repeat(np.repeat(base, 2, axis=1), 2, axis=2)
    base = base[:, :h, :w_eye + shift]
    return np.ascontiguousarray(np.concatenate(
        [base[:, :, :w_eye], base[:, :, shift:shift + w_eye]], axis=2))


def profile_kernels(fn, reps: int = 10):
    """(device operations per call, {name: (launches per call, device ms
    per call)}) from a ``torch.profiler`` trace of ``reps`` calls of ``fn``
    after a warm-up call."""
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
    return (sum(n for n, _ in per.values()) / reps,
            {k: (n / reps, us / 1e3 / reps) for k, (n, us) in per.items()})


# (batch, height, width, num_disparities, min_disparity, block_size)
B1_CASES = [
    (1, 5, 70, 16, 0, 5),
    (3, 9, 257, 32, 0, 5),
    (1, 137, 1000, 48, 0, 5),
    (3, 137, 70, 128, 0, 5),
    (1, 9, 257, 64, 3, 5),
    (1, 137, 257, 128, 3, 5),
    (1, 9, 70, 35, 0, 5),   # no vector width divides D
    (1, 9, 70, 50, 0, 5),   # pairs
    (1, 9, 70, 36, 3, 5),   # runs of four
    (1, 5, 70, 16, 0, 7),   # fewer rows than the ring holds
    (3, 2, 33, 16, 0, 3),
    (1, 70, 257, 64, 0, 9),
    (2, 1080, 1920, 64, 0, 5),
    (8, 1080, 1920, 64, 0, 5),
]

# (batch, height, width, num_disparities, min_disparity)
B3_SHAPES = [
    (1, 5, 70, 16, 0),
    (3, 9, 257, 32, 0),
    (1, 137, 1000, 48, 0),
    (3, 137, 257, 128, 0),
    (1, 9, 257, 64, 3),
    (1, 9, 257, 70, 0),  # three disparities a lane, no vector loads
    # batches of small frames that on an H100 (132 multiprocessors) make
    # B3 pick its 32-warp blocks, one per lane layout, the last in two
    # launches; then 16-warp blocks in two launches
    (132, 5, 70, 16, 0),
    (26, 9, 257, 64, 0),
    (14, 9, 257, 70, 0),
    (28, 9, 257, 128, 3),
    (31, 9, 257, 64, 0),
]
B3_CASES = [shape + (paths, margin) for shape in B3_SHAPES
            for paths in (2, 4, 5, 8) for margin in (False, True)] + [
    (b, 1080, 1920, 64, 0, paths, True) for b in (2, 8) for paths in (5, 8)]

# B3's packed route (``sgm.vertical_route`` "packed"): (batch, height,
# width, num_disparities, min_disparity, p2, fill of the cost: B1's on a
# gray pair, or random, every cost at cost_max, or 0 / cost_max
# alternating): D from one lane-run to four, odd widths and heights, pairs
# half past D (D = 18, 33), the largest P2 the route admits at the
# defaults (4449), 32-warp blocks, and the stage's batch of 8 at 1080p
B3_PACKED_CASES = [
    (1, 37, 257, 16, 0, 2400.0, "gray"),
    (3, 9, 131, 32, 0, 2400.0, "gray"),
    (1, 45, 199, 48, 3, 2400.0, "gray"),
    (2, 21, 333, 64, 0, 2400.0, "gray"),
    (1, 19, 129, 18, 0, 2400.0, "random"),
    (1, 13, 101, 33, 0, 2400.0, "random"),
    (1, 11, 97, 128, 0, 2400.0, "random"),
    (1, 9, 77, 64, 0, 4449.0, "random"),
    (1, 9, 77, 64, 0, 4449.0, "max"),
    (1, 9, 77, 48, 0, 4449.0, "alternate"),
    (1, 9, 77, 64, 0, 2400.0, "alternate"),
    (26, 9, 257, 64, 0, 2400.0, "gray"),
    (8, 1080, 1920, 64, 0, 2400.0, "gray"),
]

# (batch, height, width, num_disparities, num_paths): B3's shapes, then
# widths of 1, 2, below and around twice the ring of pixels in flight, and
# enough rows that a warp takes more than one group of them
B2_SHAPES = [shape[:4] for shape in B3_SHAPES] + [
    (1, 3, 1, 16), (2, 3, 2, 64), (1, 5, 7, 64), (1, 5, 16, 35),
    (3, 5, 17, 128), (1, 5, 24, 70), (1, 5, 33, 64), (40, 540, 70, 16),
    (12, 1080, 40, 64), (2, 1080, 1920, 64), (8, 1080, 1920, 64),
]
B2_CASES = [shape + (paths,) for shape in B2_SHAPES for paths in (5, 8)]

# (batch, height, width, min_region, max_diff, fill): a strip has 108
# output columns at radius 10 and a segment 64 rows
B4_CASES = [
    (2, 40, 200, 100, 32.0, "random"),
    (1, 137, 257, 9, 32.0, "random"),
    (3, 64, 108, 100, 32.0, "random"),
    (1, 65, 109, 100, 32.0, "random"),
    (1, 129, 217, 100, 64.0, "random"),   # 2 bands
    (1, 9, 40, 100, 32.0, "random"),      # shorter than the radius
    (3, 24, 17, 100, 32.0, "random"),     # narrower than the window
    (1, 24, 30, 400, 32.0, "random"),     # radius 20
    (1, 70, 130, 1, 32.0, "random"),      # radius 2
    (1, 137, 257, 9, 16.0, "random"),     # 5 bands: the histogram scheme
    (3, 70, 300, 100, 8.0, "random"),     # 9 bands
    (1, 70, 130, 400, 8.0, "random"),
    (1, 70, 130, 1, 8.0, "random"),
    (1, 137, 257, 100, 1.0, "random"),    # a band a disparity
    (1, 70, 130, 100, 32.0, "valid"),
    (1, 70, 130, 100, 32.0, "invalid"),
    (1, 70, 130, 9, 8.0, "valid"),
    (1, 70, 130, 9, 8.0, "invalid"),
    (2, 1080, 1920, 100, 32.0, "random"),
    (8, 1080, 1920, 100, 32.0, "random"),
]


# (batch, num_disparities, width, image rows HL, cost and accumulator type,
# entry): "both" is the two-direction entry, "fwd" / "rev" the one-direction
# one, "+acc" adding into a given accumulator
B8C_CASES = [
    (1, 64, 90, 1152, "i16/i16", "both"),    # the mxu route's padded rows
    (3, 16, 1, 1, "i16/i16", "both"),
    (1, 32, 2, 7, "i16/f32", "both"),
    (3, 35, 7, 40, "f32/f32", "both"),
    (1, 48, 8, 70, "i16/i16", "both"),
    (1, 70, 9, 130, "i16/f32", "both"),
    (3, 128, 257, 40, "i16/i16", "both"),
    (1, 64, 257, 70, "f32/f32", "both"),
    (1, 16, 90, 130, "i16/f32", "both"),
    (3, 64, 9, 7, "i16/i16", "both"),
    (1, 128, 8, 130, "f32/f32", "both"),
    (1, 35, 257, 1152, "i16/f32", "both"),
    (1, 64, 90, 70, "i16/i16", "fwd"),
    (1, 64, 90, 70, "i16/i16", "rev+acc"),
    (1, 64, 90, 70, "i16/f32", "rev"),
    (1, 64, 90, 70, "i16/f32", "fwd+acc"),
    (1, 64, 90, 70, "f32/f32", "fwd"),
    (1, 64, 90, 70, "f32/f32", "rev+acc"),
    (3, 35, 9, 7, "i16/f32", "rev+acc"),
    (1, 128, 2, 130, "f32/f32", "fwd+acc"),
    (3, 16, 257, 40, "i16/i16", "rev"),
    (1, 70, 1, 1, "f32/f32", "fwd"),
    (1, 48, 7, 1152, "i16/f32", "fwd+acc"),
    (3, 32, 8, 70, "f32/f32", "rev+acc"),
    (1, 128, 257, 40, "i16/i16", "fwd+acc"),
] + [(2, 64, 90, 70, t, e) for t in ("i16/i16", "i16/f32", "f32/f32")
     for e in ("fwd+acc", "rev+acc")] + [
    (2, 64, 1920, 1080, "i16/i16", "both"),    # the xla route's rows
    (2, 64, 1920, 1080, "i16/f32", "both"),
    (2, 64, 1920, 1152, "i16/i16", "both"),    # the mxu route's
    (2, 64, 1920, 1080, "i16/i16", "fwd"),
    (2, 64, 1920, 1080, "i16/i16", "rev+acc"),
]
_B8C_TYPES = {"i16": torch.int16, "f32": torch.float32}

# (batch, height, width, num_disparities, num_paths, cost type, p1, p2):
# the card test's first shape at every mode and type, then D 1 to 128,
# widths 1 to 257, heights 1 to 137; on an H100 (132 multiprocessors) the
# 26 frames of 257 x 64 take 32-warp blocks in one launch and the 40 frames
# 16-warp blocks in two chunks
B8A_CASES = [(2, 30, 70, 40, paths, t, 6.0, 24.0)
             for t in ("f32", "bf16") for paths in (2, 4, 5, 8)] + [
    (1, 1, 1, 1, 8, "f32", 6.5, 24.25),
    (3, 5, 7, 1, 5, "bf16", 6.5, 24.25),
    (1, 137, 257, 16, 8, "f32", 6.5, 24.25),
    (2, 9, 130, 57, 8, "bf16", 6.5, 24.25),
    (1, 40, 200, 57, 5, "f32", 7.3, 30.1),
    (1, 17, 257, 64, 4, "f32", 6.5, 24.25),
    (1, 2, 16, 64, 2, "f32", 6.5, 24.25),
    (1, 64, 96, 96, 8, "f32", 6.5, 24.25),
    (2, 33, 65, 96, 5, "bf16", 6.5, 24.25),
    (1, 20, 129, 128, 8, "f32", 7.3, 30.1),
    (3, 7, 33, 128, 4, "bf16", 6.5, 24.25),
    (2, 1, 300, 40, 8, "f32", 6.5, 24.25),
    (1, 137, 1, 16, 8, "bf16", 6.5, 24.25),
    (26, 9, 257, 64, 8, "f32", 6.5, 24.25),
    (40, 9, 257, 64, 8, "f32", 6.5, 24.25),
    (40, 9, 257, 64, 5, "bf16", 6.5, 24.25),
] + [(2, 1080, 1920, 64, paths, t, 200.0, 800.0)
     for paths, t in ((8, "f32"), (8, "bf16"), (5, "f32"), (5, "bf16"),
                      (4, "f32"), (2, "f32"))]
_B8A_TYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# (batch, height, width, num_disparities), each run in int16 and f32
B8B_CASES = [
    (1, 1, 1, 1),
    (2, 40, 90, 64),
    (1, 64, 3, 17),
    (1, 70, 257, 40),
    (3, 128, 90, 128),    # H = HP: no padding row
    (1, 130, 257, 1),
    (2, 130, 3, 64),
    (1, 40, 257, 128),
    (1, 64, 90, 17),
    (2, 70, 1, 40),
    (1, 1, 257, 64),
    (1, 128, 3, 1),
    (1, 130, 90, 17),
    (1, 64, 1, 128),
    (2, 70, 90, 40),
    (2, 1080, 1920, 64),  # the stage's volume, HP = 1152
]

# shapes of the probe's inputs: n and the last axis no multiple of 8, rows
# shorter than the select's 4 columns, one element
P_CASES = [(3, 5, 7), (1,), (2, 3, 9), (5, 13), (4, 3), (17,), (2, 1000),
           (1, 1, 8), (6, 4), (8, 64, 256)]


# I1: (batch, height, SBS width, unsqueeze): the stage's half-SBS and
# full-SBS 1080p batches, batch 1, an odd width whose eyes' rows are no
# multiple of 16 bytes and whose output is no multiple of 4 columns (129
# columns an eye), a narrow eye whose border taps merge, and one pixel
I1_CASES = [(8, 1080, 1920, True), (8, 1080, 3840, False),
            (1, 1080, 1920, True), (1, 1080, 3840, False),
            (3, 37, 258, True), (3, 37, 258, False), (2, 5, 14, True),
            (2, 3, 6, False), (1, 1, 2, True), (2, 1080, 1920, True)]

# B5's public warp: (height, width, r): the finest flow level at
# flow_scale 4 (r = 4 + search), others, and the full-resolution depth warp
B5_CASES = [(270, 480, 6), (37, 53, 4), (540, 960, 16), (1080, 1920, 16)]

# B6's public match: (height, width), the finest flow level at flow_scale 4
B6_CASES = [(270, 480), (37, 53), (5, 7)]

# B7a and B7b: (batch, heads, sequence, head dim, dtype); 577 (DPT-large's
# tokens at two keyframes and at the K=1 hybrid's eight), 77, 130 and 1500
# are no multiple of the kernel's 64-key tile
B7_CASES = [shape + (t,) for t in ("f32", "bf16") for shape in (
    (2, 3, 77, 32), (1, 6, 130, 16), (2, 16, 577, 64), (1, 4, 1500, 32),
    (8, 16, 577, 64))]


def _at_offset(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``x`` whose data starts ``offset`` elements
    past the start of a fresh allocation (1: not 16-byte aligned)."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


def gray_pair(b: int, h: int, w: int, shift: int, seed: int, device):
    """(b, h, w) f32 eyes of one random texture, ``shift`` pixels apart."""
    r = np.random.default_rng(seed)
    base = r.uniform(0, 255, (b, h, w + shift)).astype(np.float32)
    return (torch.from_numpy(base[:, :, :w].copy()).to(device),
            torch.from_numpy(base[:, :, shift:shift + w].copy()).to(device))


def check_i1(device, b, h, w, unsqueeze, seed=17) -> None:
    """I1 against its twin (the dense f32 matrix product, TF32 off):
    gray and RGB within 1e-3 on the 0-255 scale, the RGB eyes with the
    twin's strides, the same bits on a second run."""
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.integers(0, 256, (b, h, w, 3),
                                    dtype=np.uint8)).to(device)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = eyes_gray_plain(x, unsqueeze, want_rgb=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    for want_rgb in (False, True):
        got = image.eyes_gray(x, unsqueeze, want_rgb)
        again = image.eyes_gray(x, unsqueeze, want_rgb)
        torch.cuda.synchronize()
        n = 4 if want_rgb else 2
        for k in range(n):
            err = (got[k] - want[k]).abs().max().item()
            assert got[k].shape == want[k].shape and err <= 1e-3, (
                f"I1 {b}x{h}x{w} unsqueeze={unsqueeze} output {k}: {err}")
            assert got[k].stride() == want[k].stride(), (
                got[k].stride(), want[k].stride())
            assert torch.equal(got[k], again[k])
        assert all(t is None for t in got[n:])


def check_b1(device, b, h, w, d, min_d, block, seed=7) -> None:
    """B1 on the card equals its twin bit for bit, cost and filtered left."""
    p = SGBMParams(num_disparities=d, min_disparity=min_d, block_size=block)
    gl, gr = gray_pair(b, h, w, min(3 + min_d, w // 4), seed, device)
    inv = 2.0 * p.prefilter_cap
    n = costvol.launches
    cost, lf = costvol.cost_volume(gl, gr, p, inv, return_filtered_left=True)
    assert costvol.launches == n + 1
    cost_p, lf_p = costvol.cost_volume_plain(gl, gr, p, inv, True)
    torch.cuda.synchronize(device)
    what = f"B1 at {(b, h, w, d)} min_d {min_d} block {block}"
    assert cost.shape == (b, h, w, d) and cost.dtype == torch.int16, what
    assert torch.equal(lf, lf_p), f"{what}: filtered left differs"
    err = (cost.int() - cost_p.int()).abs().max().item()
    assert err == 0, f"{what}: max |err| {err}"


def check_b3(device, b, h, w, d, min_d, paths, margin, seed=8) -> None:
    """B3 on the card against its twin on B1's cost and B2's accumulator:
    identical validity, disparity within 1e-5, margin within rtol 1e-6;
    the horizontal accumulator is read, never the total. 4 and 8 paths,
    and D in (64, 96], take the int32 route; the rest of 5 paths the
    packed one."""
    p = SGBMParams(num_disparities=d, min_disparity=min_d, num_paths=paths)
    route = sgm.vertical_route(torch.int16, p)
    assert route == ("packed" if paths == 5 and not 64 < d <= 96
                     else "int32"), route
    gl, gr = gray_pair(b, h, w, min(3 + min_d, w // 4), seed, device)
    cost = costvol.cost_volume(gl, gr, p, 2.0 * p.prefilter_cap)
    acc = sgm.horizontal_sweeps(cost, p)
    want = sgm.vertical_sweeps_wta_plain(cost, acc, p, margin)
    n, n_packed = sgm.wta_launches, sgm.vertical_packed_launches
    got = sgm.vertical_sweeps_wta(cost, acc.clone(), p, margin)
    assert sgm.wta_launches == n + 1
    assert sgm.vertical_packed_launches == n_packed + (route == "packed")
    torch.cuda.synchronize(device)
    what = f"B3 at {(b, h, w, d)} min_d {min_d}, {paths} paths"
    if margin:
        (want, want_m), (got, got_m) = want, got
        assert torch.allclose(got_m, want_m, rtol=1e-6, atol=0.0), \
            f"{what}: margin differs"
    assert got.shape == (b, h, w) and got.dtype == torch.float32, what
    assert torch.equal(got >= min_d, want >= min_d), \
        f"{what}: validity differs"
    err = (got - want).abs().max().item()
    assert err <= 1e-5, f"{what}: max |err| {err}"


def right_keys(rkey, b, h, w, d, md, cw) -> torch.Tensor:
    """The right-image key min v*256 + d of each xr, (B, H, W) int32, from
    a closing B3 launch's strips of ``cw`` columns (INT_MAX: no vote), as
    ``lr_kernel`` looks it up."""
    strips, n_r = -(-w // cw), cw + d - 1
    runs = rkey[:b * h * strips * n_r].view(b * h, strips * n_r)
    xr = (torch.arange(strips, device=rkey.device).view(strips, 1) * cw
          - (d - 1) - md + torch.arange(n_r, device=rkey.device)).view(-1)
    ok = (xr >= 0) & (xr < w)
    out = torch.full((b * h, w), 2**31 - 1, dtype=torch.int32,
                     device=rkey.device)
    out.scatter_reduce_(1, xr[ok].expand(b * h, -1), runs[:, ok], "amin")
    return out.view(b, h, w)


def twin_right_keys(cost, acc, p) -> torch.Tensor:
    """The same plane from the twin's integer totals: the least total[y,
    xr + d + md, d] * 256 + d over d."""
    total = stereo.sgm_vertical_dmajor(cost.permute(0, 1, 3, 2),
                                       acc.permute(0, 1, 3, 2), p)
    b, h, d, w = total.shape
    md = int(p.min_disparity)
    out = torch.full((b, h, w), 2**31 - 1, dtype=torch.int32,
                     device=cost.device)
    for dd in range(d):
        if dd + md < w:
            keys = total[:, :, dd, dd + md:].to(torch.int32) * 256 + dd
            torch.minimum(out[..., :w - dd - md], keys,
                          out=out[..., :w - dd - md])
    return out


def check_b3_packed(device, b, h, w, d, min_d, p2, fill, seed=21) -> None:
    """B3's packed route against its int32 route on the card (disparity
    before the LR check and margin bit for bit), both routes' right-image
    keys against the twin's, and, through ``vertical_sweeps_wta``, the
    twin's disparity, validity and margin bit for bit; one packed
    launch."""
    p = SGBMParams(num_disparities=d, min_disparity=min_d, p2=p2)
    assert sgm.vertical_route(torch.int16, p) == "packed"
    if fill == "gray":
        gl, gr = gray_pair(b, h, w, min(3 + min_d, w // 4), seed, device)
        cost = costvol.cost_volume(gl, gr, p, 2.0 * p.prefilter_cap)
    else:
        cost_max = p.block_size**2 * 2 * p.prefilter_cap
        if fill == "random":
            r = np.random.default_rng(seed)
            v = r.integers(0, cost_max + 1, (b, h, w, d))
        elif fill == "max":
            v = np.full((b, h, w, d), cost_max)
        else:  # 0 / cost_max alternating over y, x and d
            v = np.indices((b, h, w, d))[1:].sum(axis=0) % 2 * cost_max
        cost = torch.from_numpy(v.astype(np.int16)).to(device)
    acc = sgm.horizontal_sweeps(cost, p)
    what = f"B3 packed at {(b, h, w, d)} min_d {min_d} P2 {p2} {fill}"
    want_keys = twin_right_keys(cost, acc, p)
    routes = []
    for packed in (True, False):
        disp, margin, rkey = sgm.vertical_launches(cost, acc, p, True, packed)
        keys = right_keys(rkey, b, h, w, d, min_d, sgm.vertical_plan[5])
        assert torch.equal(keys, want_keys), \
            f"{what}: right-image keys of the packed={packed} route differ"
        routes.append((disp, margin))
    for k, name in enumerate(("disparity", "margin")):
        assert torch.equal(routes[0][k], routes[1][k]), \
            f"{what}: {name} differs from the int32 route"
    del routes, want_keys
    n = sgm.vertical_packed_launches
    got, got_m = sgm.vertical_sweeps_wta(cost, acc, p, True)
    assert sgm.vertical_packed_launches == n + 1
    want, want_m = sgm.vertical_sweeps_wta_plain(cost, acc, p, True)
    torch.cuda.synchronize(device)
    assert torch.equal(got >= min_d, want >= min_d), \
        f"{what}: validity differs"
    err = (got - want).abs().max().item()
    assert torch.equal(got, want), f"{what}: max |err| {err}"
    assert torch.equal(got_m, want_m), f"{what}: margin differs"


def check_b2(device, b, h, w, d, paths, seed=9) -> None:
    """B2 on the card, one launch, equals its twin bit for bit on a random
    cost of B1's range, in the accumulator type of ``paths``."""
    p = SGBMParams(num_disparities=d, num_paths=paths)
    r = np.random.default_rng(seed)
    cost = torch.from_numpy(r.integers(0, 1551, (b, h, w, d)).astype(
        np.int16)).to(device)
    n = sgm.sweep_launches
    acc = sgm.horizontal_sweeps(cost, p)
    assert sgm.sweep_launches == n + 1
    want = sgm.horizontal_sweeps_plain(cost, p)
    torch.cuda.synchronize(device)
    what = f"B2 at {(b, h, w, d)}, {paths} paths"
    assert acc.dtype == (torch.float32 if paths == 8 else torch.int16), what
    assert acc.shape == cost.shape, what
    err = (acc.double() - want.double()).abs().max().item()
    assert err == 0, f"{what}: max |err| {err}"


def check_b8c(device, b, d, w, hl, types, entry, seed=13) -> None:
    """B8c on the card, one launch, equals its twin bit for bit and a second
    run of itself: an int16 cost of B1's range with whole penalties, or a
    non-integer f32 cost with non-integer ones."""
    cost_dt, acc_dt = (_B8C_TYPES[t] for t in types.split("/"))
    r = np.random.default_rng(seed)
    if cost_dt == torch.int16:
        cost = r.integers(0, 1551, (b, d, w, hl)).astype(np.int16)
        p1, p2, acc_hi = 600.0, 2400.0, 10000
    else:
        cost = r.uniform(0, 100, (b, d, w, hl)).astype(np.float32)
        p1, p2, acc_hi = 7.25, 30.5, 1000
    cost = torch.from_numpy(cost).to(device)
    acc = None
    if entry.endswith("+acc"):
        a = r.uniform(0, acc_hi, cost.shape)
        acc = torch.from_numpy(a if acc_dt == torch.float32 and
                               cost_dt == torch.float32 else a.round()).to(
            device, acc_dt)
    if entry == "both":
        def run():
            return wmajor.horizontal_sweeps_wmajor_kernel(cost, p1, p2,
                                                          acc_dt)
        want = wmajor.horizontal_sweeps_wmajor_plain(cost, p1, p2, acc_dt)
    else:
        reverse = entry.startswith("rev")

        def run():
            return wmajor.wmajor_sweep(cost, None if acc is None else
                                       acc.clone(), p1, p2, reverse, acc_dt)
        want = wmajor.wmajor_sweep_plain(cost, acc, p1, p2, reverse, acc_dt)
    n = wmajor.sweep_launches
    got, again = run(), run()
    assert wmajor.sweep_launches == n + 2
    torch.cuda.synchronize(device)
    what = f"B8c {entry} at {(b, d, w, hl)} {types}"
    assert got.dtype == acc_dt and got.shape == cost.shape, what
    assert torch.equal(got, again), f"{what}: runs differ"
    err = (got.double() - want.double()).abs().max().item()
    assert torch.equal(got, want), f"{what}: max |err| {err}"
    if entry == "both" and cost_dt == torch.int16:
        # whole sums: the order of the two directions' adds is immaterial
        pair = wmajor.wmajor_sweep(cost, wmajor.wmajor_sweep(
            cost, None, p1, p2, False, acc_dt), p1, p2, True)
        assert torch.equal(got, pair), \
            f"{what}: differs from the two one-direction sweeps"
        b2 = sgm.horizontal_sweeps(cost.permute(0, 3, 2, 1).contiguous(),
                                   SGBMParams(num_disparities=d, p1=p1, p2=p2,
                                              num_paths=8 if acc_dt ==
                                              torch.float32 else 5))
        assert torch.equal(got.permute(0, 3, 2, 1), b2), \
            f"{what}: differs from B2's sums"


def check_b8a(device, b, h, w, d, paths, cost_type, p1, p2, seed=14) -> None:
    """B8a on the card, one call, equals its twin bit for bit and a second
    run of itself on a non-integer cost in [0, 100)."""
    r = np.random.default_rng(seed)
    cost = torch.from_numpy(r.uniform(0, 100, (b, h, w, d)).astype(
        np.float32)).to(device, _B8A_TYPES[cost_type])
    n = sgm.aggregate_launches
    got = sgm.sgm_aggregate_pallas(cost, paths, p1, p2)
    again = sgm.sgm_aggregate_pallas(cost, paths, p1, p2)
    assert sgm.aggregate_launches == n + 2
    n_call, steps = sgm.aggregate_plan
    assert steps == {2: 0, 5: 1}.get(paths, 2), sgm.aggregate_plan
    for _ in range(3):  # a trace with no device event at all was lost
        # (seen on the card): trace again; one with events is counted
        _, per = profile_kernels(
            lambda: sgm.sgm_aggregate_pallas(cost, paths, p1, p2), 5)
        if per:
            break
    n_dev = sum(n for name, (n, _) in per.items() if "horizontal_kernel"
                in name or "vertical_kernel" in name)
    assert round(n_dev) == n_call, (n_dev, sgm.aggregate_plan)
    want = sgm_aggregate(cost, SGBMParams(num_paths=paths, p1=p1, p2=p2))
    torch.cuda.synchronize(device)
    what = f"B8a at {(b, h, w, d)}, {paths} paths, {cost_type}, {p1}/{p2}"
    assert got.dtype == torch.float32 and got.shape == cost.shape, what
    assert torch.equal(got, again), f"{what}: runs differ"
    err = (got.double() - want.double()).abs().max().item()
    assert torch.equal(got, want), f"{what}: max |err| {err}"


def check_b8b(device, b, h, w, d, types, seed=15) -> None:
    """B8b on the card, one launch a way, equals its twin bit for bit and a
    second run of itself, from aligned storage and from storage one
    element past it; the inverse reads a W-major volume whose padding rows
    hold garbage."""
    dt = _B8C_TYPES[types]
    r = np.random.default_rng(seed)
    if dt == torch.int16:
        x = torch.from_numpy(r.integers(-32768, 32768, (b, h, w, d)).astype(
            np.int16)).to(device)
    else:
        x = torch.from_numpy(r.standard_normal((b, h, w, d)).astype(
            np.float32)).to(device)
    want = wmajor.transpose_to_wmajor_plain(x)
    garbage = want.clone()
    garbage[..., h:] = torch.from_numpy(r.integers(
        1, 1000, garbage[..., h:].shape)).to(device, dt)
    what = f"B8b at {(b, h, w, d)} {types}"
    for offset in (0, 1):
        xs, gs = _at_offset(x, offset), _at_offset(garbage, offset)
        n = wmajor.transpose_launches
        t, t2 = wmajor.transpose_to_wmajor(xs), wmajor.transpose_to_wmajor(xs)
        back = wmajor.transpose_from_wmajor(gs, h)
        back2 = wmajor.transpose_from_wmajor(gs, h)
        assert wmajor.transpose_launches == n + 4
        torch.cuda.synchronize(device)
        where = f"{what}, storage offset {offset}"
        assert t.shape == want.shape and t.dtype == dt, where
        assert torch.equal(t, t2) and torch.equal(back, back2), \
            f"{where}: runs differ"
        assert torch.equal(t, want), \
            f"{where}: to differs in {int((t != want).sum().item())} elements"
        assert torch.equal(t[..., :h], x.permute(0, 3, 2, 1)), \
            f"{where}: differs from the permute"
        assert torch.equal(back, x), \
            f"{where}: from differs in {int((back != x).sum().item())} " \
            f"elements"


def check_p(device, shape, seed=16) -> None:
    """P on the card: the six ops in one launch, and each op alone, equal
    the torch expressions bit for bit on full-range int16 inputs, from
    aligned storage and from storage one element past it."""
    r = np.random.default_rng(seed)
    xs = [torch.from_numpy(r.integers(-32768, 32768, shape).astype(
        np.int16)).to(device) for _ in range(3)]
    want = probe_i16.probe_all_plain(xs)
    for offset in (0, 1):
        ins = [_at_offset(x, offset) for x in xs]
        n = probe_i16.launches
        got = probe_i16.probe_all(*ins)
        assert probe_i16.launches == n + 1
        for k, (name, (_, n_in, _)) in enumerate(probe_i16.OPS.items()):
            alone = probe_i16.probe_op(name, *ins[:n_in])
            torch.cuda.synchronize(device)
            what = f"P {name} at {shape}, storage offset {offset}"
            assert got[k].shape == tuple(shape), what
            assert torch.equal(got[k], want[k]), what
            assert torch.equal(alone, want[k]), f"{what}, alone"
        assert probe_i16.launches == n + 1 + len(probe_i16.OPS)


def speckle_map(b: int, h: int, w: int, fill: str, seed: int, device):
    """(b, h, w) f32 disparities in [0, 64), the left half in flat blobs,
    ``fill`` of "random" (30% invalid), "valid" or "invalid" (-1)."""
    r = np.random.default_rng(seed)
    disp = r.uniform(0, 64, (b, h, w)).astype(np.float32)
    disp[:, :, : w // 2] = np.floor(disp[:, :, : w // 2] / 24) * 24
    if fill == "random":
        disp[r.uniform(size=disp.shape) < 0.3] = -1.0
    elif fill == "invalid":
        disp[:] = -1.0
    return torch.from_numpy(disp).to(device)


def check_b4(device, b, h, w, min_region, max_diff, fill, seed=10) -> None:
    """B4 on the card equals its twin bit for bit."""
    disp = speckle_map(b, h, w, fill, seed, device)
    n = speckle.launches
    got = speckle.speckle_filter(disp, -1.0, max_diff, min_region,
                                 (0.0, 64.0))
    assert speckle.launches == n + 1
    want = speckle_filter_device(disp, -1.0, max_diff, min_region,
                                 (0.0, 64.0))
    torch.cuda.synchronize(device)
    what = (f"B4 at {(b, h, w)} min_region {min_region} max_diff {max_diff} "
            f"{fill}")
    assert torch.equal(got, want), \
        f"{what}: {int((got != want).sum().item())} pixels differ"


# (height, width, levels, max_flow): r_lvl = ceil(max_flow / 2^lvl) + 2
FLOW_LEVEL_CASES = [
    (5, 7, 3, 4), (5, 7, 4, 7), (37, 53, 3, 4), (68, 120, 3, 7),
    (135, 241, 4, 4), (270, 480, 3, 4), (271, 479, 4, 7), (540, 960, 3, 7),
]

# (height, width, guide height, guide width, max_warp, d_gate_gain)
EMA_CASES = [
    (20, 28, 5, 7, 16, 1.0), (20, 28, 5, 7, 8, 0.0),
    (148, 212, 37, 53, 16, 1.0), (136, 240, 68, 120, 8, 1.0),
    (270, 479, 68, 120, 16, 0.0), (1080, 1920, 270, 480, 16, 1.0),
    (1080, 1920, 540, 960, 16, 1.0), (1080, 1920, 540, 960, 8, 0.0),
]


def smooth_plane(h: int, w: int, seed: int, device, scale=255.0):
    """(h, w) f32 texture in [0, scale): random values on a grid 4x
    coarser, resized (bilinear), so every level has gradient to match."""
    r = np.random.default_rng(seed)
    base = torch.from_numpy(r.uniform(0, scale, (h // 4 + 2, w // 4 + 2))
                            .astype(np.float32)).to(device)
    return resize2d(base, h, w, "bilinear").contiguous()


def check_flow_level(device, h, w, levels, max_flow, seed=11) -> None:
    """B6's level step on the card against its twin at every step of the
    pyramid walk, flow within 2e-4 px, the same bits on a second run; each
    step starts from the kernel's own flow of the step before."""
    cur = smooth_plane(h, w, seed, device)
    prev = flow.shift_edge(cur, 1, -2).contiguous()
    fy = fx = None
    for lvl, (c, p) in reversed(list(enumerate(
            flow._pyramid(cur, prev, levels)))):
        r_lvl = -(-max_flow // (2 ** lvl)) + 2
        for _ in range(2 if lvl == levels - 1 else 1):
            n = flowmatch.launches
            got = flowmatch.flow_level(c, p, fy, fx, 2, 3, 2.0, r_lvl)
            again = flowmatch.flow_level(c, p, fy, fx, 2, 3, 2.0, r_lvl)
            assert flowmatch.launches == n + 2
            want = flow.flow_level_plain(c, p, fy, fx, 2, 3, 2.0, r_lvl)
            torch.cuda.synchronize(device)
            what = (f"B6 level {lvl} of {levels} at {tuple(c.shape)} from "
                    f"{(h, w)}, r_lvl {r_lvl}")
            for g, a, wv in zip(got, again, want):
                assert g.shape == c.shape, what
                assert torch.equal(g, a), f"{what}: runs differ"
                err = (g - wv).abs().max().item()
                assert err <= 2e-4, f"{what}: max |err| {err} px"
            fy, fx = got


def check_ema_tail(device, h, w, hq, wq, max_warp, gain_d, seed=12) -> None:
    """B5's EMA step on the card against its twin on unit-scale depth:
    within 1e-4, the same bits on a second run (the gate's mean is summed
    in a fixed order), two launches (three with the gate)."""
    p = flow.FlowEMAParams(max_warp=max_warp, d_gate_gain=gain_d)
    rq = max(1, int(round(max_warp / max(h / hq, w / wq))))
    r = np.random.default_rng(seed)
    depth = smooth_plane(h, w, seed, device, 1.0)
    prev_out = (flow.shift_edge(depth, 2, -3) + torch.from_numpy(r.normal(
        0, 0.05, (h, w)).astype(np.float32)).to(device)).contiguous()
    g = smooth_plane(hq, wq, seed + 1, device)
    prev_g = flow.shift_edge(g, 0, 1).contiguous()
    # past the clamp on purpose: both sides must clamp to [-rq, rq]
    fy, fx = (torch.from_numpy(r.uniform(-rq - 1, rq + 1, (hq, wq)).astype(
        np.float32)).to(device) for _ in range(2))
    n = warp.launches
    got = warp.ema_tail(p, depth, prev_out, g, prev_g, fy, fx, rq)
    again = warp.ema_tail(p, depth, prev_out, g, prev_g, fy, fx, rq)
    assert warp.launches == n + 2 * (3 if gain_d > 0 else 2)
    want = flow.ema_tail_plain(p, depth, prev_out, g, prev_g, fy, fx, rq)
    torch.cuda.synchronize(device)
    what = (f"B5 EMA step at {(h, w)} from {(hq, wq)}, max_warp {max_warp}, "
            f"gate {gain_d}")
    assert torch.equal(got, again), f"{what}: runs differ"
    err = (got - want).abs().max().item()
    assert err <= 1e-4, f"{what}: max |err| {err}"


def _uniform(seed, lo, hi, shape, device):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.uniform(lo, hi, shape).astype(np.float32)).to(
        device)


def check_b5(device, h, w, r) -> None:
    """B5's public warp, one launch, within 1e-5 of its twin on a
    unit-scale image, the flow past the clamp on purpose: both sides must
    clamp to [-r, r]."""
    img = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (h, w)).astype(np.float32)).to(device)
    fy = _uniform(22, -r - 1, r + 1, (h, w), device)
    fx = _uniform(23, -r - 1, r + 1, (h, w), device)
    n = warp.launches
    got = warp.warp_bilinear_shifts(img, fy, fx, r)
    assert warp.launches == n + 1
    want = flow.warp_bilinear_shifts_plain(img, fy, fx, r)
    err = (got - want).abs().max().item()
    assert err <= 1e-5, f"B5 at {(h, w)} r={r}: max |err| {err}"


def check_b6(device, h, w) -> None:
    """B6's public match, one launch, within 2e-4 px of its twin on
    band-limited textures (gradient everywhere to match)."""
    import scipy.ndimage as ndi

    def texture(seed):
        t = ndi.gaussian_filter(np.random.default_rng(seed).standard_normal(
            (h, w)), 2.0)
        t = (t - t.min()) / (np.ptp(t) + 1e-9)
        return torch.from_numpy((t * 255.0).astype(np.float32)).to(device)

    args = (texture(3), texture(4), _uniform(5, -3, 3, (h, w), device),
            _uniform(6, -3, 3, (h, w), device))
    n = flowmatch.launches
    got = flowmatch.flow_match(*args, search=2, radius=3, tau=2.0)
    assert flowmatch.launches == n + 1
    want = flow.flow_match_plain(*args, search=2, radius=3, tau=2.0)
    for g, wv in zip(got, want):
        err = (g - wv).abs().max().item()
        assert err <= 2e-4, f"B6 at {(h, w)}: max |err| {err} px"


def check_b7(device, b, heads, s, d, dtype, seed=5) -> None:
    """B7a and B7b, one launch each, against their twin: within 1e-5 in
    f32; in bf16 within 2^-7 |twin| + 2^-10 (about one bf16 ulp) on at
    least 99.9% of the outputs."""
    r = np.random.default_rng(seed)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    q, k, v = (torch.from_numpy(r.standard_normal((b, heads, s, d)).astype(
        np.float32)).to(device, dt) for _ in range(3))
    sm = 1.0 / d ** 0.5
    want = attention_plain(q, k, v, sm).float()
    n = attention.launches
    for name, fn in (("B7a", attention.attention_multihead),
                     ("B7b", attention.attention_oneblock)):
        err = (fn(q, k, v, sm).float() - want).abs()
        what = f"{name} at {(b, heads, s, d)} {dtype}"
        if dt == torch.float32:
            assert err.max().item() <= 1e-5, f"{what}: {err.max().item()}"
        else:
            frac = (err <= 2.0 ** -7 * want.abs() + 2.0 ** -10).float()
            assert frac.mean().item() >= 0.999, f"{what}: {frac.mean()}"
    assert attention.launches == n + 2


# F1 and F2: (batch, height, width, every, guide, fill): heights and widths
# below the window's 17 (it clips at both edges), off F2's strip of 240
# columns and its segment of 64 rows, every K with a last group short of
# K; then 1080p half-SBS at batch 2 and 8, K = 1 and 4, both guides, the
# fill on, and at batch 8 off; last a stereo guide that goes below 0 over
# much of the frame (``signed``: the published CREStereo's disparity is
# not clamped) at batch 8, K = 1 and 4
FB_CASES = [
    (2, 9, 40, 1, "stereo", True), (3, 16, 13, 2, "mono", True),
    (1, 1, 5, 1, "mono", True), (2, 5, 1, 1, "stereo", True),
    (5, 23, 250, 4, "mono", False), (4, 70, 300, 4, "stereo", False),
    (3, 65, 241, 2, "mono", True), (8, 129, 481, 4, "stereo", True),
    (6, 64, 240, 4, "mono", True), (2, 33, 17, 1, "stereo", False),
] + [(b, 1080, 1920, k, g, True) for b in (2, 8) for k in (1, 4)
     for g in ("stereo", "mono")] + [
    (8, 1080, 1920, k, g, False) for k in (1, 4) for g in ("stereo", "mono")
] + [(8, 1080, 1920, k, "signed", True) for k in (1, 4)]


def blend_inputs(b: int, h: int, w: int, every: int, guide: str, seed: int,
                 device) -> tuple:
    """(disp, margin, the guide's output) f32 for F1 and F2 at D = 64:
    ``disp`` a smooth field in [1, 60] with noise and 10% holes (-1),
    holes at both ends of every 5th row, row 2 of frame 0 blank, frame 1
    all holes (no confident mass: trust 1, a degenerate fit); ``margin``
    uniform in [0, 1], a twentieth of that in the left quarter (windows
    under 2% of confident mass: the frame's ratio); the guide on
    ceil(b / every) keyframes: ``stereo`` the field with noise, 20 px off
    in a block; ``signed`` the same 35 px lower (below 0 over much of
    the frame); ``mono`` an affine map of the field with noise, the last
    of two or more keyframes reversed (a fit with s <= 0: the min-max
    landing)."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    field = 30.5 + 29.5 * np.sin(xx * 6.0 / w + yy * 3.0 / h)
    disp = (field + r.normal(0.0, 0.3, (b, h, w))).astype(np.float32)
    disp[r.random(disp.shape) < 0.1] = -1.0
    disp[:, ::5, :3] = -1.0
    disp[:, ::5, -2:] = -1.0
    disp[0, min(2, h - 1)] = -1.0
    disp[1:2] = -1.0
    margin = r.uniform(0.0, 1.0, (b, h, w)).astype(np.float32)
    margin[:, :, :w // 4] *= 0.05
    g = -(-b // every)
    if guide in ("stereo", "signed"):
        out = field + r.normal(0.0, 1.0, (g, h, w))
        out[:, h // 3:h // 2, w // 2:3 * w // 4] += 20.0
        if guide == "signed":
            out -= 35.0
    else:
        out = 0.5 * field + 3.0 + r.normal(0.0, 0.1, (g, h, w))
        if g > 1:
            out[-1] *= -1.0
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        device) for a in (disp, margin, out))


def check_fill_blend(device, b, h, w, every, guide, fill, seed=18) -> None:
    """F1's fill (one launch) bit-equal to its twin; the blend (two
    launches, three for a monocular guide) the same bits on a second run,
    and within 1e-3 px of its twin (``stages/depth.py blend_plain``) on
    >= 99.9% of the pixels and within 1 px on all: the kernels sum in
    another order than the twin's f32 cumulative sums, which can flip the
    trust gate (``den > 0.02 * area``) at a few pixels."""
    from video3d_tpu_torch.stages.depth import blend_plain

    p = SGBMParams()
    disp, margin, out = blend_inputs(b, h, w, every, guide, seed, device)
    stereo = guide != "mono"
    what = f"F1/F2 at {(b, h, w)}, K={every}, {guide}, fill {fill}"
    n = blend.launches
    if fill:
        filled = blend.fill_holes(disp, -1.0)
        assert torch.equal(filled, fill_holes(disp, -1.0)), f"{what}: fill"
        disp = filled
    args = (disp, margin, out, every, stereo)
    got = blend.trust_blend(*args, p.num_disparities, p.min_disparity)
    again = blend.trust_blend(*args, p.num_disparities, p.min_disparity)
    assert blend.launches == n + fill + 2 * (2 if stereo else 3), what
    want = blend_plain(*args, p)
    torch.cuda.synchronize(device)
    assert torch.equal(got, again), f"{what}: runs differ"
    err = (got - want).abs()
    within = (err <= 1e-3).float().mean().item()
    assert within >= 0.999, f"{what}: {within} within 1e-3 px"
    assert err.max().item() <= 1.0, f"{what}: max |err| {err.max().item()}"


# A1: (batch, channels, height, width, small, deformable, reach): the 3x3
# window (``small``) or the 1x9 row, the deformable route (offsets) or the
# warped one; ``reach`` the flow's scale in pixels. First tiles off both
# tile shapes (128 pixels: 2 x 64 and 8 x 16), a map one pixel high or
# wide, a few pixels (also against the float64 point loop), one group (64
# channels) and batch 1, flows that carry most points outside the frame;
# then the main path's levels at batch 2 (two keyframes, 4 groups):
# warped at 136x240 and 68x120, deformable at 34x60 and 17x30, both
# patterns each; then the K = 1 cell's batch of 8 at 68x120
A1_CASES = [
    (b, c, h, w, small, deformable, reach)
    for (b, c, h, w, reach) in ((2, 256, 37, 53, 6.0), (1, 256, 1, 50, 3.0),
                                (1, 256, 50, 1, 3.0), (2, 256, 3, 5, 4.0),
                                (1, 64, 9, 70, 2.0), (2, 256, 17, 30, 40.0))
    for small in (False, True) for deformable in (False, True)
] + [(2, 256, h, w, small, deformable, 3.0)
     for (h, w, deformable) in ((136, 240, False), (68, 120, False),
                                (34, 60, True), (17, 30, True))
     for small in (False, True)] + [
    (8, 256, 68, 120, small, deformable, 3.0)
    for small in (False, True) for deformable in (False, True)]
# maps of at most this many pixels (batch included) are also held to the
# float64 point loop
A1_LOOP_PIXELS = 64


def bilinear_at(img: np.ndarray, x: float, y: float) -> np.ndarray:
    """img (C, H, W) at pixel (x, y): the four taps, zero outside."""
    c, hh, ww = img.shape
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    out = np.zeros(c)
    for yy, xx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)):
        wgt = (1.0 - abs(x - xx)) * (1.0 - abs(y - yy))
        if 0 <= yy < hh and 0 <= xx < ww:
            out += wgt * img[:, yy, xx]
    return out


def agcl_points(small: bool) -> list:
    """(dx, dy) of the 3x3 window (``small``) or the 1x9 row, row-major."""
    if small:
        return [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return [(dx, 0) for dx in range(-4, 5)]


def agcl_loop(f1, f2, flow, offset, small, groups) -> torch.Tensor:
    """The AGCL point by point in float64 on CPU tensors: deformable
    (``offset``) or warped and shifted with replicate padding. The CPU
    tests hold the twin and the reference to it; :func:`check_a1`, A1."""
    f1, f2, flow = (t.double().numpy() for t in (f1, f2, flow))
    b, c, h, w = f1.shape
    cg = c // groups
    pts = agcl_points(small)
    out = np.zeros((b, groups * 9, h, w))
    for n in range(b):
        warped = np.zeros((c, h, w))
        for y, x in itertools.product(range(h), range(w)):
            warped[:, y, x] = bilinear_at(f2[n], x + flow[n, 0, y, x],
                                          y + flow[n, 1, y, x])
        for g, (k, (dx, dy)), y, x in itertools.product(
                range(groups), enumerate(pts), range(h), range(w)):
            sl = slice(g * cg, (g + 1) * cg)
            if offset is None:
                yy, xx = min(max(y + dy, 0), h - 1), min(max(x + dx, 0), w - 1)
                right = warped[sl, yy, xx]
            else:
                o = offset[n].double().numpy()
                right = bilinear_at(f2[n, sl],
                                    x + flow[n, 0, y, x] + dx + o[2 * k, y, x],
                                    y + flow[n, 1, y, x] + dy
                                    + o[2 * k + 1, y, x])
            out[n, g * 9 + k, y, x] = np.mean(f1[n, sl, y, x] * right)
    return torch.from_numpy(out)


def agcl_inputs(b, c, h, w, deformable, reach, seed, device) -> tuple:
    """(f1, f2, flow, offset or None) for A1: standard normal maps
    channels-last, a flow of scale ``reach`` px (NCHW), offsets uniform in
    [-1, 1] (the model's bound) channels-last."""
    r = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    f1, f2 = (agcl.kernel_layout(t(r.standard_normal((b, c, h, w))))
              for _ in range(2))
    flow = t(reach * r.standard_normal((b, 2, h, w)))
    offset = (agcl.kernel_layout(t(r.uniform(-1.0, 1.0, (b, 18, h, w))))
              if deformable else None)
    return f1, f2, flow, offset


def check_a1(device, b, c, h, w, small, deformable, reach, seed=19) -> None:
    """A1, one launch a call, against its twin (``models/crestereo_net.py
    agcl_warped`` / ``agcl_deformable``, f32 on the card): within 1e-4 of
    the largest |corr|. Both compute the sampling coordinates in f32, but
    the twin's round trip through grid_sample's normalised grid moves them
    by up to ~W x 2^-23 px (3e-5 px at 240 columns), which on features of
    random sign moves a correlation by up to ~3e-5 of the largest; the
    64-term sums differ only in order (~1e-6). On maps of at most
    ``A1_LOOP_PIXELS`` pixels also against :func:`agcl_loop` (the CPU
    tests' float64 point loop), within 1e-5 of the largest |corr|: there
    every coordinate is under 64 px and exact to 4e-6 px in f32. A second
    call
    with the flow channels-last and ``out`` given gives the same bits."""
    from video3d_tpu_torch.models.crestereo_net import (agcl_deformable,
                                                        agcl_warped)

    f1, f2, flow, offset = agcl_inputs(b, c, h, w, deformable, reach, seed,
                                       device)
    groups = c // agcl.GROUP_CHANNELS
    what = (f"A1 at {(b, c, h, w)}, {'3x3' if small else '1x9'}, "
            f"{'deformable' if deformable else 'warped'}, reach {reach}")
    n = agcl.launches
    got = agcl.correlate(f1, f2, flow, offset, small, groups)
    assert got.shape == (b, 9 * groups, h, w) and got.is_contiguous(
        memory_format=torch.channels_last), what
    flow_cl = flow.contiguous(memory_format=torch.channels_last)
    again = agcl.correlate(f1, f2, flow_cl, offset, small, groups,
                           out=torch.empty_like(got))
    assert agcl.launches == n + 2, what
    if deformable:
        want = agcl_deformable(f1, f2, flow, offset, small, groups)
    else:
        want = agcl_warped(f1, f2, flow, small, groups)
    torch.cuda.synchronize(device)
    assert torch.equal(got, again), f"{what}: runs differ"
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * scale, f"{what}: max |err| {err} of {scale}"
    if b * h * w <= A1_LOOP_PIXELS:
        ref = agcl_loop(*(None if x is None else x.cpu()
                          for x in (f1, f2, flow, offset)), small, groups)
        err = (got.cpu().double() - ref).abs().max().item()
        scale = ref.abs().max().item()
        assert err <= 1e-5 * scale, f"{what}: loop max |err| {err} of {scale}"
