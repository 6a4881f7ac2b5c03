"""Kernels F1 and F2 (``csrc/blend.cu``) and their wrapper, on the CPU.

The CUDA kernels cannot run here, so numpy repeats the order in which
they scan, sum and select, and is held to the twins the card holds the
kernels to:

- F1's fill (``fill_row``): a row in steps of 32 lanes; a lane takes the
  nearest valid value at or left of it from the step's ballot, or the
  carry of the steps before, the same from the right on the way back, and
  a hole the smaller of the two. Bit-equal to ``ops/fill.py fill_holes``.
- F1's statistics and F2 (``stats_kernel``, ``tile_kernel``): a frame's
  sums in double, its fit and its trust fallback, a monocular guide
  landed, then strips of columns walked down segments of rows with a ring
  of the last 17 rows, running vertical sums in double, a 17-wide
  horizontal sum of them in f32 and the window's area in closed form,
  frame i reading keyframe i // K.
  Within 5e-5 px of ``stages/depth.py blend_plain`` in float64 (the
  kernels' per-pixel steps are f32) and within 1e-3 px, the card's gate,
  of the same in float32, whose cumulative sums are off by up to 1.2e-4
  px at these widths.

And the wrapper on the CPU: its fill is the plain fill, ``guidance_blend``
runs its plain code (``fused`` 0 in span ``stage.blend``), and the trust
blend refuses a CPU tensor; the closed-form window area is ``box_sum_2d``
of ones, and keyframe i // K is what ``repeat_interleave`` gave.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from video3d_tpu_torch.core import trace
from video3d_tpu_torch.kernels import blend
from video3d_tpu_torch.ops.boxsum import box_sum_2d
from video3d_tpu_torch.ops.fill import fill_holes
from video3d_tpu_torch.ops.stereo import SGBMParams
from video3d_tpu_torch.stages.depth import (blend_plain,
                                            confidence_trust_blend,
                                            guidance_blend)
from video3d_tpu_torch.tools.card_checks import FB_CASES, blend_inputs

LANES = 32
R = 8  # the trust window's radius (csrc/blend.cu R)
WIN = 2 * R + 1
F32 = np.float32
P = SGBMParams()


def fill_row_order(row: np.ndarray, invalid: float) -> np.ndarray:
    """One row through F1's fill, step by step as a warp runs it."""
    w = row.shape[0]
    inv = F32(invalid)
    lanes = np.arange(LANES)
    left = np.empty(w, F32)
    out = np.empty(w, F32)
    carry = F32(np.inf)
    for x0 in range(0, w, LANES):
        x = x0 + lanes
        inb = x < w
        v = np.where(inb, row[np.minimum(x, w - 1)], inv)
        valid = inb & (v != inv)
        upto = np.maximum.accumulate(np.where(valid, lanes, -1))
        got = np.where(upto >= 0, v[np.maximum(upto, 0)], carry)
        left[x[inb]] = got[inb]
        if valid.any():
            carry = v[lanes[valid].max()]
    carry = F32(np.inf)
    for x0 in range((w - 1) // LANES * LANES, -1, -LANES):
        x = x0 + lanes
        inb = x < w
        v = np.where(inb, row[np.minimum(x, w - 1)], inv)
        valid = inb & (v != inv)
        frm = np.minimum.accumulate(
            np.where(valid, lanes, LANES)[::-1])[::-1]
        got = np.where(frm < LANES, v[np.minimum(frm, LANES - 1)], carry)
        f = np.minimum(left[x[inb]], got[inb])
        f = np.where(np.isinf(f), inv, f)
        out[x[inb]] = np.where(valid[inb], v[inb], f)
        if valid.any():
            carry = v[lanes[valid].min()]
    return out


def frame_landing(p, c, sp, nd):
    """F1's statistics of one frame and its monocular landing: the sums in
    double of the twin's f32 terms, the fit in double, used in f32."""
    f64 = np.float64
    mass = c.astype(f64).sum()
    s_p, s_t = (p * c).astype(f64).sum(), (sp * c).astype(f64).sum()
    s_pp, s_pt = (p * p * c).astype(f64).sum(), (p * sp * c).astype(f64).sum()
    n = max(mass, 1.0)
    det = n * s_pp - s_p * s_p
    s = (n * s_pt - s_p * s_t) / det if abs(det) > 1e-6 else 1.0
    s32, t32 = F32(s), F32((s_t - s * s_p) / n)
    lo = F32(p.min())
    rng = np.maximum(F32(p.max()) - lo, F32(1e-6))
    if s32 > 0:
        return np.minimum(np.maximum(p * s32 + t32, F32(0)), F32(nd))
    return (p - lo) / rng * F32(nd)


def win_count(i, n):
    return np.minimum(i + R, n - 1) - np.maximum(i - R, 0) + 1


def blend_order(disp, margin, out, every, stereo, nd, md, nt=256, seg=64):
    """The trust blend as F1's statistics and F2 compute it; ``nt``
    threads a block (strips of nt - 16 output columns) and ``seg`` output
    rows a segment (the kernel's: 256 and 64)."""
    d, m, g = (t.numpy() for t in (disp, margin, out))
    b, h, w = d.shape
    f64 = np.float64
    conf = np.where(d > F32(md - 0.5), m, F32(0))
    sp = np.maximum(d, F32(0))
    res = np.empty_like(d)
    t = np.arange(nt)
    for i in range(b):
        gk = g[i // every]
        gl = gk if stereo else frame_landing(gk, conf[i], sp[i], nd)
        agree = np.where(np.abs(gl - sp[i]) <= F32(2), conf[i], F32(0))
        mass = conf[i].astype(f64).sum()
        q = F32(agree.astype(f64).sum() / max(mass, 1e-6)
                if mass >= 32.0 else 1.0)
        for x0 in range(-R, w - R, nt - 2 * R):
            x = x0 + t
            col_in = (x >= 0) & (x < w)
            out_col = (t >= R) & (t < nt - R) & (x < w)
            xo = x[out_col]
            for y0 in range(0, h, seg):
                ring_c = np.zeros((WIN, nt), F32)
                ring_a = np.zeros((WIN, nt), F32)
                vc, va = np.zeros(nt), np.zeros(nt)
                for k in range(min(y0 + seg, h) - y0 + 2 * R):
                    j, slot = y0 - R + k, k % WIN
                    c, ag = np.zeros(nt, F32), np.zeros(nt, F32)
                    if 0 <= j < h:
                        c[col_in] = conf[i, j, x[col_in]]
                        ag[col_in] = agree[j, x[col_in]]
                    vc += c.astype(f64) - ring_c[slot].astype(f64)
                    va += ag.astype(f64) - ring_a[slot].astype(f64)
                    ring_c[slot], ring_a[slot] = c, ag
                    o = j - R
                    if o < y0:
                        continue
                    rc, ra = vc.astype(F32), va.astype(F32)
                    den, num = np.zeros(nt, F32), np.zeros(nt, F32)
                    for u in range(-R, R + 1):
                        den[out_col] += rc[t[out_col] + u]
                        num[out_col] += ra[t[out_col] + u]
                    den, num = den[out_col], num[out_col]
                    area = (win_count(o, h) * win_count(xo, w)).astype(F32)
                    trust = np.where(den > F32(0.02) * area,
                                     num / np.maximum(den, F32(1e-6)), q)
                    cc = ring_c[(k - R) % WIN][out_col]
                    c2 = F32(1) - (F32(1) - cc) * np.clip(trust, F32(0),
                                                          F32(1))
                    res[i, o, xo] = c2 * sp[i, o, xo] + (F32(1) - c2) * gl[
                        o, xo]
    return torch.from_numpy(res)


def _disp_maps(b, h, w, seed):
    r = np.random.default_rng(seed)
    d = r.uniform(0.0, 64.0, (b, h, w)).astype(np.float32)
    d[r.random(d.shape) < 0.35] = -1.0
    d[:, :, :min(w, 6)] = -1.0
    d[0, min(1, h - 1)] = -1.0
    return torch.from_numpy(d)


@pytest.mark.parametrize("shape", [(3, 12, 40), (2, 5, 70), (1, 3, 1),
                                   (2, 4, 32), (2, 4, 33), (1, 2, 97)])
def test_f1_fill_order_bit_equal_to_twin(shape):
    d = _disp_maps(*shape, seed=sum(shape))
    got = np.stack([fill_row_order(row, -1.0) for row in
                    d.numpy().reshape(-1, shape[-1])]).reshape(shape)
    np.testing.assert_array_equal(got, fill_holes(d, -1.0).numpy())


def test_f1_fill_order_on_the_blend_inputs():
    d = blend_inputs(3, 11, 75, 1, "stereo", 4, "cpu")[0]
    got = np.stack([fill_row_order(row, -1.0) for row in
                    d.numpy().reshape(-1, 75)]).reshape(d.shape)
    np.testing.assert_array_equal(got, fill_holes(d, -1.0).numpy())


def test_fill_wrapper_on_cpu_is_the_plain_fill():
    d = _disp_maps(2, 9, 50, 3)
    n = blend.launches
    assert torch.equal(blend.fill_holes(d, -1.0), fill_holes(d, -1.0))
    assert blend.launches == n


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (16, 17), (17, 33),
                                   (9, 40), (30, 3), (2, 18)])
def test_window_count_is_box_sum_of_ones(shape):
    """F2's closed-form area, (min(i + 8, n - 1) - max(i - 8, 0) + 1) along
    each axis, is the twin's ``box_sum_2d`` of ones."""
    h, w = shape
    area = win_count(np.arange(h), h)[:, None] * win_count(np.arange(w), w)
    want = box_sum_2d(torch.ones(h, w), R)
    assert torch.equal(torch.from_numpy(area.astype(np.float32)), want)


@pytest.mark.parametrize("b,k", [(8, 4), (8, 1), (6, 4), (3, 2), (1, 4),
                                 (5, 5)])
def test_keyframe_index_is_repeat_interleave(b, k):
    """Frame i reading keyframe i // K, as F1 and F2 do, is the twin's
    ``repeat_interleave``."""
    keys = torch.arange(-(-b // k), dtype=torch.float32)[:, None] * 10.0
    want = keys.repeat_interleave(k, dim=0)[:b]
    assert torch.equal(keys[torch.arange(b) // k], want)


@pytest.mark.parametrize("case", [c for c in FB_CASES if c[1] < 1080],
                         ids=str)
def test_blend_order_matches_twin(case):
    """The kernels' order on the card's small cases, at their own strip and
    segment (256 threads, 64 rows) and at 32 threads and 5 rows, so that
    these shapes cross many strips and segments."""
    b, h, w, every, guide, fill = case
    disp, margin, out = blend_inputs(b, h, w, every, guide, 18, "cpu")
    if fill:
        disp = fill_holes(disp, -1.0)
    stereo = guide == "stereo"
    want = blend_plain(disp, margin, out, every, stereo, P)
    want64 = blend_plain(disp.double(), margin.double(), out.double(),
                         every, stereo, P)
    for nt, seg in ((256, 64), (32, 5)):
        got = blend_order(disp, margin, out, every, stereo,
                          P.num_disparities, P.min_disparity, nt, seg)
        err64 = (got.double() - want64).abs().max().item()
        assert err64 <= 5e-5, (nt, seg, err64)
        err = (got - want).abs().max().item()
        assert err <= 1e-3, (nt, seg, err)


@pytest.mark.parametrize("every", [1, 4])
@pytest.mark.parametrize("stereo", [True, False])
def test_guidance_blend_on_cpu_is_the_plain_code(every, stereo):
    """On the CPU the stage's fill and blend are the plain code as it was:
    the fill of ``ops/fill.py``, then the keyframes expanded by
    ``repeat_interleave``, a monocular guide landed and
    ``confidence_trust_blend``; ``stage.blend`` counts no fused frame."""
    from video3d_tpu_torch.models.mono import ssi_align

    b, h, w = 6, 20, 48
    disp, margin, out = blend_inputs(b, h, w, every, "stereo" if stereo
                                     else "mono", 5, "cpu")
    eyes = torch.zeros(b, h, w, 3)

    def guide_fn(left, right=None):
        assert left.shape[0] == out.shape[0]
        return out

    guide_fn.stereo = stereo
    trace.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got = guidance_blend(blend.fill_holes(disp, -1.0), margin, eyes,
                                 eyes, guide_fn, P, guidance_every=every)
        counts = trace.summary()["stage.blend"]["counts"]
    finally:
        trace.reset()
    assert counts == {"fused": 0}
    filled = fill_holes(disp, -1.0)
    full = out.repeat_interleave(every, dim=0)[:b]
    if not stereo:
        lo = full.amin(dim=(-2, -1), keepdim=True)
        hi = full.amax(dim=(-2, -1), keepdim=True)
        mm = (full - lo) / torch.clamp(hi - lo, min=1e-6) * 64.0
        s, t = ssi_align(full, torch.clamp(filled, min=0.0),
                         torch.where(filled > -0.5, margin, 0.0))
        full = torch.where(s > 0.0, torch.clamp(full * s + t, 0.0, 64.0),
                           mm)
    want = confidence_trust_blend(filled, margin, full)
    assert torch.equal(got, want)


def test_trust_blend_refuses_cpu_tensors():
    disp, margin, out = blend_inputs(2, 5, 9, 1, "stereo", 0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        blend.trust_blend(disp, margin, out, 1, True, 64, 0)
