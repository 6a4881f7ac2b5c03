"""The arithmetic order of the redesigned CUDA kernels B1 and B3, on CPU.

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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video3d_tpu.kernels.costvol import fused_cost_volume
from video3d_tpu_torch.kernels import costvol
from video3d_tpu_torch.ops import stereo

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
