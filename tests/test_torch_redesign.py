"""The arithmetic order of the redesigned CUDA kernels B1-B4, on CPU.

The CUDA kernels cannot run here, so plain torch repeats the order in
which they sum and select, and is held to the twins the card holds the
kernels to, and to the JAX kernels in interpret mode:

- B1 (``csrc/costvol.cu``): per input row the horizontal window sum of the
  2x-scaled raw cost, kept as uint16 in a ring of ``block_size`` rows; the
  vertical sum runs (add the row that enters, subtract the row that
  leaves) in int32; a segment of rows warms its ring up over ``2*pad``
  rows above it; the halving rounds half to even with integer operations.
  Bit-equal to ``cost_volume_plain`` and to JAX ``fused_cost_volume``.
- B3's closing pass (``csrc/sgm.cu``): the left-image WTA from a pixel's
  totals by the ``v*256 + d`` key, the right-image WTA as a scatter-min of
  the same keys into a plane filled with INT_MAX, the LR check after.
  Equal to ``wta_total_dmajor`` on integer totals with many ties.
- B2 (``csrc/sgm.cu horizontal_kernel``): a row's two directions run from
  its two ends at the same time, each pixel on ``lanes * runs >= D``
  disparities with the sentinel cost past D and no mask in the step; up to
  the middle each stores its own path sum, past it each adds its own to
  what the other stored, an odd width's middle pixel gets both at once; the
  other's sum comes from a ring filled ``HPF`` iterations ahead (before that
  iteration's stores) where it was stored by then, else straight from the
  accumulator. Bit-equal to ``horizontal_sweeps_plain`` and to JAX
  ``_directional_pass_dmajor`` run forward then reverse.
- B8a (B2's and B3's kernels on an f32 or bf16 cost): the horizontal pair
  in B2's order with the 1e9 sentinel past D set back after every step,
  then each vertical launch adding the vertical, dx +1 and dx -1 path
  values to the accumulator in that order. Bit-equal to ``sgm_aggregate``.
- B4 (``csrc/speckle.cu``): the band from the twin's expression; for up to
  four bands the cumulative band indicators as the bytes of a 32-bit word,
  a horizontal window sum of the words, a ring of 2r+1 rows of them and a
  running vertical sum in 16-bit fields; for more bands a ring of band
  codes, a per-column histogram of the ring in bytes and a horizontal sum
  of three bands of it; segments of rows warm up over r rows above them.
  Bit-equal to ``speckle_filter_device`` and to JAX ``speckle_filter_pallas``.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video3d_tpu.kernels.costvol import fused_cost_volume
from video3d_tpu.kernels.sgm import _directional_pass_dmajor
from video3d_tpu.kernels.speckle import (speckle_block_rows,
                                         speckle_filter_pallas)
from video3d_tpu.ops.speckle import speckle_filter_device as jax_speckle
from video3d_tpu_torch.kernels import _build, costvol, sgm
from video3d_tpu_torch.ops import stereo
from video3d_tpu_torch.ops.speckle import (speckle_filter_device,
                                           speckle_geometry)

INT_MAX = 2**31 - 1


def b1_kernel_order(left_gray, right_gray, p, raw_invalid, seg_h):
    """(B, H, W, D) int16 cost in the order of ``cost_kernel``."""
    lf = stereo.xsobel_clip(left_gray, p.prefilter_cap)
    rf = stereo.xsobel_clip(right_gray, p.prefilter_cap)
    raw = stereo.bt_cost_volume_dmajor(lf, rf, p.num_disparities,
                                       p.min_disparity, raw_invalid)
    raw2 = (2.0 * raw).to(torch.int32).permute(0, 1, 3, 2)  # (B, H, W, D)
    assert torch.equal(raw2.to(torch.float32), 2.0 * raw.permute(0, 1, 3, 2))
    b, h, w, d = raw2.shape
    pad = p.block_size // 2
    r = 2 * pad + 1
    zeros = torch.zeros((b, pad, d), dtype=torch.int32)
    out = torch.full((b, h, w, d), -1, dtype=torch.int32)
    for y0 in range(0, h, seg_h):
        y1 = min(y0 + seg_h, h)
        vs = torch.zeros((b, w, d), dtype=torch.int32)
        ring = torch.zeros((r, b, w, d), dtype=torch.int32)
        slot = 0
        for yy in range(y0 - pad, y1 + pad):
            hs = torch.zeros((b, w, d), dtype=torch.int32)
            if 0 <= yy < h:
                row = torch.cat([zeros, raw2[:, yy], zeros], dim=1)
                for k in range(r):
                    hs = hs + row[:, k:k + w]
            leaving = yy - r >= y0 - pad
            vs = vs + hs - (ring[slot] if leaving else 0)
            ring[slot] = hs & 0xFFFF  # the ring holds uint16
            y = yy - pad
            if y >= y0:
                half = vs >> 1
                out[:, y] = half + ((vs & 1) & (half & 1))
            slot = (slot + 1) % r
    assert (out >= 0).all()
    return out.to(torch.int16)


def _pair(seed, b, h, w, shift):
    r = np.random.default_rng(seed)
    base = r.uniform(0, 255, (b, h, w + shift)).astype(np.float32)
    return base[:, :, :w].copy(), base[:, :, shift:shift + w].copy()


@pytest.mark.parametrize("b,h,w,d,min_d,block,seg_h", [
    (2, 16, 37, 16, 0, 5, 64),   # one segment, odd width
    (1, 16, 37, 16, 0, 5, 6),    # segments, the last one short
    (1, 3, 37, 16, 0, 5, 8),     # fewer rows than the window
    (1, 12, 53, 48, 0, 5, 4),    # a segment as tall as its warm-up
    (1, 6, 131, 128, 0, 5, 64),
    (1, 9, 41, 16, 0, 7, 5),
])
def test_b1_order_bit_equal_to_twin_and_jax(b, h, w, d, min_d, block, seg_h):
    left, right = _pair(31, b, h, w, 3)
    p = stereo.SGBMParams(num_disparities=d, min_disparity=min_d,
                          block_size=block)
    inv = 2.0 * p.prefilter_cap
    got = b1_kernel_order(torch.from_numpy(left), torch.from_numpy(right), p,
                          inv, seg_h)
    want = costvol.cost_volume_plain(torch.from_numpy(left),
                                     torch.from_numpy(right), p, inv)
    assert torch.equal(got, want)
    jax_cost = fused_cost_volume(
        jnp.asarray(left), jnp.asarray(right), d, block, out_dtype=jnp.int16,
        raw_invalid=inv, interpret=True, prefilter_cap=p.prefilter_cap)
    np.testing.assert_array_equal(got.permute(0, 1, 3, 2).numpy(),
                                  np.asarray(jax_cost))


@pytest.mark.parametrize("h,w,d,min_d,seg_h", [
    (11, 37, 16, 3, 4), (3, 53, 48, 3, 64), (7, 140, 128, 3, 3),
    (23, 37, 16, 0, 8),
])
def test_b1_order_against_twin_alone(h, w, d, min_d, seg_h):
    """``min_disparity = 3`` (the JAX kernel has no such argument), and a
    height of 23 (in interpret mode the JAX kernel's last rows differ from
    the twin's at heights above 16 that are no multiple of 8, such as 17
    and 23): against the twin alone."""
    left, right = _pair(32, 1, h, w, 5)
    p = stereo.SGBMParams(num_disparities=d, min_disparity=min_d)
    inv = 2.0 * p.prefilter_cap
    args = (torch.from_numpy(left), torch.from_numpy(right), p, inv)
    assert torch.equal(b1_kernel_order(*args, seg_h),
                       costvol.cost_volume_plain(*args))


def b3_close_order(total, p, return_margin=False):
    """WTA of (B, H, W, D) integer totals in the order of the closing
    ``vertical_kernel`` launch and ``lr_kernel``."""
    b, h, w, nd = total.shape
    md, uniq, lr = (int(p.min_disparity), int(p.uniqueness_ratio),
                    int(p.disp12_max_diff))
    t = total.to(torch.int32)
    ds = torch.arange(nd, dtype=torch.int32)
    key = (t * 256 + ds).amin(dim=-1)  # the first minimum wins ties
    s_min, d_int = key >> 8, key & 255
    sel = d_int.long().unsqueeze(-1)
    s_m1 = torch.gather(t, 3, (sel - 1).clamp(min=0))[..., 0]
    s_p1 = torch.gather(t, 3, (sel + 1).clamp(max=nd - 1))[..., 0]
    far = (ds - d_int.unsqueeze(-1)).abs() > 1
    sec = torch.where(far, t, stereo._SENT).amin(dim=-1)
    fs, fm1, fp1 = (v.to(torch.float32) for v in (s_min, s_m1, s_p1))
    denom = (fm1 + fp1) - 2.0 * fs
    sub = torch.where(denom > 1e-6, (fm1 - fp1) / (2.0 * denom + 1e-12),
                      torch.zeros_like(denom)).clamp(-0.5, 0.5)
    sub = torch.where((d_int == 0) | (d_int == nd - 1),
                      torch.zeros_like(sub), sub)
    dval = (d_int.to(torch.float32) + sub) + float(md)
    xs = torch.arange(w)
    valid = (xs >= md + nd).expand(b, h, w)
    second = torch.where(sec == stereo._SENT, torch.full_like(fs, 1e9),
                         sec.to(torch.float32))
    if uniq > 0:
        valid = valid & (second * 100.0 >= fs * (100.0 + uniq))
    margin = (second - fs).clamp(min=0.0) / (fs + 1.0)
    disp = torch.where(valid, dval, torch.full_like(dval, float(md - 1)))
    if lr >= 0:
        # pixel x votes v*256 + d for xr = x - d - md: a scatter-min
        xr = xs.view(w, 1) - ds.view(1, nd).long() - md  # (W, D)
        votes = torch.where(xr >= 0, t * 256 + ds, INT_MAX)
        index = xr.clamp(min=0).view(1, w * nd).expand(b * h, w * nd)
        rkey = torch.full((b * h, w), INT_MAX, dtype=torch.int32)
        rkey = rkey.scatter_reduce(1, index, votes.reshape(b * h, w * nd),
                                   "amin").view(b, h, w)
        # the LR check, after: only valid pixels look their winner up
        dl = disp - float(md)
        dr = torch.round(dl).long().clamp(0, nd - 1)
        at = xs.view(1, 1, w) - md - dr
        d_right = (torch.gather(rkey, 2, at.clamp(min=0)) & 255).to(
            torch.float32)
        ok = (at >= 0) & ((dl - d_right).abs() <= float(lr))
        disp = torch.where((disp >= md) & ~ok,
                           torch.full_like(disp, float(md - 1)), disp)
    return (disp, margin) if return_margin else disp


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
@pytest.mark.parametrize("w,nd,min_d,lr,uniq", [
    (70, 16, 0, 1, 10), (131, 48, 0, 1, 10), (150, 128, 0, 1, 10),
    (70, 16, 3, 1, 10), (70, 16, 0, -1, 10), (70, 16, 0, 2, 0),
])
def test_b3_close_order_equals_wta_twin(dtype, w, nd, min_d, lr, uniq):
    """Random integer totals in a narrow range, so first and second minima
    tie often, as int16 and as the f32 accumulator of MODE_HH."""
    r = np.random.default_rng(41)
    total = torch.from_numpy(r.integers(100, 112, (2, 6, w, nd))).to(dtype)
    # half the pixels get a clear winner, so the LR check has valid pixels
    win = torch.from_numpy(r.integers(0, nd, (2, 6, w)))
    clear = torch.from_numpy(r.uniform(size=(2, 6, w)) < 0.5)
    total.scatter_(3, win.unsqueeze(-1), torch.where(
        clear, 40, 105).to(dtype).unsqueeze(-1))
    p = stereo.SGBMParams(num_disparities=nd, min_disparity=min_d,
                          disp12_max_diff=lr, uniqueness_ratio=uniq)
    want, want_m = stereo.wta_total_dmajor(total.permute(0, 1, 3, 2), p,
                                           return_margin=True)
    got, got_m = b3_close_order(total, p, return_margin=True)
    assert torch.equal(got, want)
    assert torch.equal(got_m, want_m)
    assert 0.05 < (got >= min_d).float().mean() < 0.95


HPF = 8  # pixels in flight per scan line of horizontal_kernel


def b2_kernel_order(cost, p, hpf=HPF):
    """Sum of both horizontal paths of a (B, H, W, D) int16 cost in the
    order of ``horizontal_kernel``; memory it may not read yet holds a
    poison value."""
    b, h, w, d = cost.shape
    lanes, runs = ((8, 4) if d <= 32 else (16, 4) if d <= 64 else
                   (32, 3) if d <= 96 else (32, 4))
    dp = lanes * runs
    p1, p2 = stereo.integral_penalties(p.p1, p.p2)
    sent, poison = stereo._SENT, -(1 << 24)
    c = torch.full((b * h, w, dp), sent, dtype=torch.int32)
    c[:, :, :d] = cost.reshape(b * h, w, d).to(torch.int32)
    acc = torch.full((b * h, w, d), poison, dtype=torch.int32)
    edge = torch.full((b * h, 1), sent, dtype=torch.int32)

    def step(carry, cost_px):  # sgm_step: no mask past D
        m = carry.amin(dim=1, keepdim=True)
        dn = torch.cat([edge, carry[:, :-1]], dim=1)
        up = torch.cat([carry[:, 1:], edge], dim=1)
        best = torch.minimum(torch.minimum(carry, m + p2),
                             torch.minimum(up, dn) + p1)
        return (cost_px - m) + best

    ring = [None] * hpf

    def fetch(s):  # started before the stores of the iteration that calls it
        sums = ((acc[:, s].clone(), acc[:, w - 1 - s].clone())
                if 2 * s >= w + hpf else (None, None))
        ring[s % hpf] = (c[:, s], c[:, w - 1 - s]) + sums

    for s in range(min(hpf, w)):
        fetch(s)
    lf = torch.zeros((b * h, dp), dtype=torch.int32)
    lr = torch.zeros_like(lf)
    for t in range(w):
        cf, cr, af, ar = ring[t % hpf]
        second, ringed = 2 * t > w - 1, 2 * t >= w + hpf
        assert ringed == (af is not None)
        if t + hpf < w:
            fetch(t + hpf)
        if second and not ringed:
            af, ar = acc[:, t].clone(), acc[:, w - 1 - t].clone()
        lf, lr = step(lf, cf), step(lr, cr)
        if 2 * t == w - 1:
            acc[:, t] = (lf + lr)[:, :d]
            continue
        if second:
            assert (af != poison).all() and (ar != poison).all()
        else:
            af = ar = 0
        acc[:, t] = af + lf[:, :d]
        acc[:, w - 1 - t] = ar + lr[:, :d]
    assert (acc != poison).all()
    return acc.view(b, h, w, d).to(
        stereo.acc_dtype_for_params(cost.dtype, p))


@pytest.mark.parametrize("paths", [5, 8])  # int16 and f32 accumulator
@pytest.mark.parametrize("b,h,w,d,with_jax", [
    (2, 3, 37, 16, True), (1, 3, 40, 16, False), (1, 2, 1, 16, False),
    (1, 2, 2, 16, False), (1, 2, 5, 35, True), (1, 2, 7, 64, False),
    (1, 3, 16, 64, False), (1, 2, 17, 64, True), (1, 2, 24, 35, False),
    (1, 2, 33, 70, True), (1, 2, 9, 128, True), (1, 2, 26, 128, False),
])
def test_b2_order_bit_equal_to_twin_and_jax(b, h, w, d, with_jax, paths):
    """Widths around 2 * HPF, odd and even, below 8 and of 1 and 2; D on
    every lane layout, with and without a ragged tail. One case of each
    layout also runs the JAX kernel (the twin is held to it at the other
    shapes' kind in ``tests/test_torch_kernels.py``)."""
    r = np.random.default_rng(51)
    cost_np = r.integers(0, 1551, (b, h, w, d)).astype(np.int16)
    p = stereo.SGBMParams(num_disparities=d, num_paths=paths)
    cost = torch.from_numpy(cost_np)
    got = b2_kernel_order(cost, p)
    want = sgm.horizontal_sweeps_plain(cost, p)
    assert got.dtype == want.dtype == (torch.float32 if paths == 8
                                       else torch.int16)
    assert torch.equal(got, want)
    if not with_jax:
        return
    cost_t = jnp.asarray(cost_np.transpose(0, 2, 3, 1))  # lines along W
    acc_t = _directional_pass_dmajor(
        cost_t, None, (0,), p.p1, p.p2, False, interpret=True,
        acc_dtype=jnp.float32 if paths == 8 else jnp.int16)
    acc_t = _directional_pass_dmajor(cost_t, acc_t, (0,), p.p1, p.p2, True,
                                     interpret=True)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(acc_t))


BIG = np.float32(1e9)  # the f32 carry sentinel of the float sweeps


def b8a_kernel_order(cost, paths, p1, p2):
    """The f32 total of a (B, H, W, D) f32 or bf16 cost in the order of
    B8a's launches: ``horizontal_kernel``'s two chains from a row's two
    ends (the second to reach a pixel adds its path value to what the first
    stored), then one ``vertical_kernel`` launch per sweep step, each
    adding to the accumulator the vertical, dx +1 and dx -1 path values in
    that order. A pixel is held on ``lanes * runs >= D`` disparities with
    the 1e9 sentinel past D, which every step sets back past D."""
    b, h, w, d = cost.shape
    lanes, runs = ((8, 4) if d <= 32 else (16, 4) if d <= 64 else
                   (32, 3) if d <= 96 else (32, 4))
    dp = lanes * runs
    big = torch.tensor(BIG)
    f1, f2 = torch.tensor(np.float32(p1)), torch.tensor(np.float32(p2))
    c = torch.full((b, h, w, dp), BIG)
    c[..., :d] = cost.to(torch.float32)
    real = torch.arange(dp) < d
    fill = torch.where(real, torch.tensor(np.float32(0)), big)

    def step(carry, cost_px):  # sgm_step over the lanes, then the mask
        m = carry.amin(dim=-1, keepdim=True)
        edge = torch.full_like(carry[..., :1], BIG)
        dn = torch.cat([edge, carry[..., :-1]], dim=-1)
        up = torch.cat([carry[..., 1:], edge], dim=-1)
        best = torch.minimum(torch.minimum(carry, m + f2),
                             torch.minimum(up, dn) + f1)
        return torch.where(real, (cost_px + best) - m, big)

    acc = torch.full((b, h, w, d), float("nan"))
    lf = lr = fill.expand(b, h, dp)
    for t in range(w):
        lf, lr = step(lf, c[:, :, t]), step(lr, c[:, :, w - 1 - t])
        if 2 * t == w - 1:  # the middle pixel of an odd width
            acc[:, :, t] = (lf + lr)[..., :d]
        elif 2 * t > w - 1:  # the other chain stored here first
            acc[:, :, t] = acc[:, :, t] + lf[..., :d]
            acc[:, :, w - 1 - t] = acc[:, :, w - 1 - t] + lr[..., :d]
        else:
            acc[:, :, t] = torch.zeros(()) + lf[..., :d]
            acc[:, :, w - 1 - t] = torch.zeros(()) + lr[..., :d]
    assert not acc.isnan().any()
    diagonals = paths in (5, 8)
    for dy in {2: (), 5: (1,)}.get(paths, (1, -1)):
        l0 = lp = ln = fill.expand(b, w, dp)
        for y in (range(h) if dy > 0 else range(h - 1, -1, -1)):
            cy = c[:, y]
            l0 = step(l0, cy)
            total = acc[:, y] + l0[..., :d]
            if diagonals:  # carries from x - 1 and x + 1, fill at the edges
                edge = fill.expand(b, 1, dp)
                lp = step(torch.cat([edge, lp[:, :-1]], dim=1), cy)
                ln = step(torch.cat([ln[:, 1:], edge], dim=1), cy)
                total = (total + lp[..., :d]) + ln[..., :d]
            acc[:, y] = total
    return acc


@pytest.mark.parametrize("b,h,w,d,paths,dtype,p1,p2", [
    (1, 1, 1, 1, 8, torch.float32, 6.5, 24.25),
    (2, 5, 7, 1, 5, torch.bfloat16, 6.5, 24.25),
    (2, 6, 9, 16, 8, torch.float32, 6.0, 24.0),
    (1, 4, 16, 40, 4, torch.float32, 7.3, 30.1),
    (1, 7, 17, 57, 8, torch.bfloat16, 6.5, 24.25),
    (1, 3, 6, 70, 2, torch.float32, 6.5, 24.25),
    (1, 5, 6, 96, 8, torch.float32, 7.3, 30.1),
    (1, 3, 5, 128, 5, torch.bfloat16, 6.5, 24.25),
])
def test_b8a_order_bit_equal_to_twin(b, h, w, d, paths, dtype, p1, p2):
    """Non-integer costs and penalties (7.3 and 30.1 round in f32), every
    mode and lane layout, widths of 1 and odd and even ones, D of 1 and
    with a ragged tail: B8a's order gives the twin's bits."""
    r = np.random.default_rng(52)
    cost = torch.from_numpy(r.uniform(0, 100, (b, h, w, d)).astype(
        np.float32)).to(dtype)
    got = b8a_kernel_order(cost, paths, p1, p2)
    want = stereo.sgm_aggregate(cost, stereo.SGBMParams(num_paths=paths,
                                                        p1=p1, p2=p2))
    assert torch.equal(got, want)


def b4_kernel_order(disp, invalid, max_diff, min_region,
                    value_range=(0.0, 64.0), seg=64):
    """The speckle vote of a (B, H, W) f32 map in the order of
    ``speckle_kernel``, with its counter widths."""
    radius, n, lo = speckle_geometry(max_diff, min_region, value_range)
    assert n < 255 and radius <= 127  # what the C entry takes
    b, h, w = disp.shape
    win = 2 * radius + 1
    valid = disp != invalid
    band = torch.clamp(torch.floor((disp - lo) / float(max_diff)).to(
        torch.int64), 0, n - 1)
    code = torch.where(valid, band, 255)
    none = torch.full((b, w), 255, dtype=torch.int64)
    out = torch.full_like(disp, float("nan"))
    u32, lo16 = 0xFFFFFFFF, 0x00FF00FF

    def window(x):  # the 2r+1 columns around each column, zero outside
        xp = torch.nn.functional.pad(x, (radius, radius))
        return sum(xp[..., k:k + w] for k in range(win))

    for y0 in range(0, h, seg):
        y1 = min(y0 + seg, h)
        even = torch.zeros((b, w), dtype=torch.int64)
        odd = torch.zeros_like(even)
        ring = torch.zeros((win, b, w), dtype=torch.int64)
        hist = torch.zeros((n, b, w), dtype=torch.int64)
        codes = none.repeat(win, 1, 1)
        slot = 0
        for i, yy in enumerate(range(y0 - radius, y1 + radius)):
            k = code[:, yy] if 0 <= yy < h else none
            full = i >= win
            if n <= 4:
                ind = torch.where(k != 255, (0x01010101 << (8 * k)) & u32, 0)
                hs = window(ind)
                assert ((hs >> 8 * 3) <= 255).all()  # no byte carried over
                old = ring[slot].clone() if full else torch.zeros_like(hs)
                ring[slot] = hs
                even = (even + (hs & lo16) - (old & lo16)) & u32
                odd = (odd + ((hs >> 8) & lo16) - ((old >> 8) & lo16)) & u32
            else:
                old = codes[slot].clone() if full else none
                codes[slot] = k
                for j in range(n):
                    hist[j] += (k == j).long() - (old == j).long()
                assert (hist >= 0).all() and (hist <= 255).all()
            yo = yy - radius
            if yo >= y0:
                ko = band[:, yo]
                if n <= 4:
                    def field(j):
                        word = torch.where(j % 2 == 1, odd, even)
                        return (word >> (16 * (j // 2))) & 0xFFFF

                    support = field(torch.clamp(ko + 1, max=n - 1)) - \
                        torch.where(ko >= 2, field(torch.clamp(ko - 2, min=0)),
                                    0)
                else:
                    hw = window(hist)  # (n, b, w)
                    support = torch.zeros((b, w), dtype=torch.int64)
                    for dj in (-1, 0, 1):
                        j = ko + dj
                        ok = (j >= 0) & (j < n)
                        support += torch.where(ok, torch.gather(
                            hw, 0, j.clamp(0, n - 1).unsqueeze(0))[0], 0)
                assert (support <= win * win).all() and (support >= 0).all()
                keep = valid[:, yo] & (support >= min_region)
                out[:, yo] = torch.where(keep, disp[:, yo],
                                         torch.full_like(disp[:, yo],
                                                         float(invalid)))
            slot = (slot + 1) % win
    return out


def _speckle_map(seed, shape, fill):
    r = np.random.default_rng(seed)
    disp = r.uniform(0, 64, shape).astype(np.float32)
    # blobs of a few bands, so some pixels pass and some fail the vote
    disp[:, : shape[1] // 2] = np.floor(disp[:, : shape[1] // 2] / 24) * 24
    if fill == "random":
        disp[r.uniform(size=shape) < 0.3] = -1.0
    elif fill == "invalid":
        disp[:] = -1.0
    return disp


@pytest.mark.parametrize("shape,min_region,max_diff,fill,seg,pallas", [
    ((1, 24, 64), 100, 32.0, "random", 64, True),  # 3 bands, the defaults
    ((1, 16, 96), 9, 32.0, "random", 64, True),
    ((2, 24, 64), 100, 32.0, "random", 7, False),  # segments with warm-up
    ((1, 16, 33), 1, 32.0, "random", 5, False),    # radius 2
    ((1, 24, 17), 100, 32.0, "random", 64, False),  # W below 2r+1
    ((1, 9, 40), 100, 32.0, "random", 4, False),   # H below 2r+1 and r
    ((1, 24, 30), 400, 32.0, "random", 64, False),  # radius 20
    ((1, 24, 64), 100, 64.0, "random", 16, True),  # 2 bands
    ((1, 16, 24), 9, 16.0, "random", 16, True),    # 5 bands: the histogram
    ((1, 24, 64), 100, 8.0, "random", 10, False),  # 9 bands
    ((1, 48, 40), 400, 8.0, "random", 64, False),
    ((1, 24, 64), 1, 8.0, "random", 64, False),
    ((1, 24, 64), 100, 32.0, "valid", 64, False),
    ((1, 24, 64), 9, 8.0, "valid", 5, False),
    ((1, 24, 64), 100, 32.0, "invalid", 64, False),
    ((1, 24, 64), 9, 8.0, "invalid", 64, False),
])
def test_b4_order_bit_equal_to_twin_and_jax(shape, min_region, max_diff,
                                            fill, seg, pallas):
    """Against the twin and the JAX package: its Pallas kernel in interpret
    mode (slow to trace, so at one shape per band layout) or its jnp
    function, to which that kernel is bit-identical by its own tests."""
    disp = _speckle_map(61, shape, fill)
    got = b4_kernel_order(torch.from_numpy(disp), -1.0, max_diff, min_region,
                          seg=seg)
    want = speckle_filter_device(torch.from_numpy(disp), -1.0, max_diff,
                                 min_region)
    assert torch.equal(got, want)
    if fill == "random" and 1 < min_region < 400:
        assert 0.0 < (got != -1.0).float().mean().item() < 0.75
    if pallas:
        radius = speckle_geometry(max_diff, min_region, (0.0, 64.0))[0]
        assert speckle_block_rows(shape[1], radius) is not None
        jax_out = speckle_filter_pallas(jnp.asarray(disp), invalid=-1.0,
                                        max_diff=max_diff,
                                        min_region=min_region, interpret=True)
    else:
        jax_out = jax_speckle(jnp.asarray(disp), -1.0, max_diff, min_region)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_out))


def _c_entries():
    """name -> ctypes argument list of every ``extern "C" int`` function in
    the CUDA sources, read from its declaration."""
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    entries = {}
    for src in sorted(_build._SRC_DIR.glob("*.cu")):
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                     src.read_text()):
            entries[name] = [
                kinds[" ".join(w for w in a.split()[:-1] if w != "const")]
                for a in args.split(",")]
    return entries


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_ctypes_signature_matches_c_declaration(name):
    """ctypes checks nothing: a wrapper's argument list that drifts from the
    C declaration passes garbage to the kernel."""
    entries = _c_entries()
    assert sorted(entries) == sorted(_build._SIGNATURES)
    assert entries[name] == _build._SIGNATURES[name]
