"""B3's packed route (``csrc/sgm.cu vertical_kernel`` with PK), on CPU.

The CUDA kernel cannot run here, so numpy repeats its arithmetic on 32-bit
words of two signed 16-bit halves, as Hopper's DPX instructions take them:
a pixel's ``lanes_per_pixel(D) * 4`` disparities as pairs (d, d + 1), the
ring's garbage past D replaced by the 16-bit sentinel, the step
``min(min(L(d-1), L(d+1), m + P2 - P1) + P1, L)`` from ``vimin3`` and
``viaddmin``, ``Ln = c + best - m`` as one 32-bit add, the total as 32-bit
adds of pairs with the halves past D set to ``TSENT16``, and the WTA's
keys ``v*256 + d`` permuted out of the pairs. Every 16-bit add wraps as
the card's does, and each wrap, and each carry or borrow that crosses from
one half into the other, is counted: on what :func:`sgm.vertical_route`
admits there are none, and the route is bit-equal to the int32 twin.
"""

import re

import numpy as np
import pytest
import torch

from video3d_tpu_torch.kernels import _build, sgm
from video3d_tpu_torch.ops import stereo
from video3d_tpu_torch.ops.stereo import SGBMParams

SENT16 = sgm.PACKED_SENT
TSENT16 = 0x7FFF
PAIR_MAX = 0x7FFF7FFF
INT_MAX = 2**31 - 1
COST_MAX = 5 * 5 * 2 * 31  # block 5, prefilter_cap 31


def lanes_per_pixel(d):
    """``sgm_common.cuh lanes_per_pixel``: lanes holding a pixel's D."""
    return 8 if d <= 32 else 16 if d <= 64 else 32


class Pairs:
    """The packed route's word operations on uint32 arrays, counting the
    16-bit wraps and the carries and borrows across halves."""

    def __init__(self):
        self.wraps = 0
        self.crossings = 0

    @staticmethod
    def halves(w):
        """(..., 2) int16 halves of uint32 words, the low half first."""
        w = np.ascontiguousarray(w, dtype=np.uint32)
        return w.view(np.int16).reshape(w.shape + (2,))

    @staticmethod
    def join(h):
        h = np.ascontiguousarray(h, dtype=np.int16)
        return h.view(np.uint32).reshape(h.shape[:-1])

    @staticmethod
    def pair_of(v):
        return np.uint32((v & 0xFFFF) * 0x10001)

    def vimin(self, a, b):
        return self.join(np.minimum(self.halves(a), self.halves(b)))

    def vimin3(self, a, b, c):
        return self.vimin(self.vimin(a, b), c)

    def viaddmin(self, a, b, c):
        """min(a + b, c) per half, the add in 16 bits."""
        exact = self.halves(a).astype(np.int32) + self.halves(b)
        wrapped = exact.astype(np.int16)  # numpy's cast wraps, as the card
        self.wraps += int((wrapped != exact).sum())
        return self.join(np.minimum(wrapped, self.halves(c)))

    @staticmethod
    def swap(w):
        return (w >> np.uint32(16)) | (w << np.uint32(16))

    @staticmethod
    def shift(x, y):
        """(high half of x, low half of y): __byte_perm(x, y, 0x5432)."""
        return (x >> np.uint32(16)) | (y << np.uint32(16))

    def add(self, *terms, sub=None, keep=None):
        """One 32-bit add (or IADD3) of packed words, ``sub`` subtracted;
        counts the low halves whose own sum leaves [0, 2^16), where the
        high half receiving the carry or borrow is kept (``keep``: the
        words' mask of halves below D; a carry out of the high half leaves
        the word)."""
        lo = sum(self.halves(t)[..., 0].view(np.uint16).astype(np.int64)
                 for t in terms)
        hi = sum(self.halves(t)[..., 1].view(np.uint16).astype(np.int64)
                 for t in terms)
        if sub is not None:
            lo = lo - self.halves(sub)[..., 0].view(np.uint16)
            hi = hi - self.halves(sub)[..., 1].view(np.uint16)
        cross = (lo < 0) | (lo >= 1 << 16)
        kept = [np.ones(lo.shape, bool)] * 2
        if keep is not None:
            kept = [self.halves(keep)[..., k] != 0 for k in (0, 1)]
            cross &= kept[1]
        self.crossings += int(cross.sum())
        # every value of the route is a non-negative int16
        self.wraps += int(sum((((v < 0) | (v >= 1 << 15)) & k).sum()
                              for v, k in zip((lo, hi), kept)))
        out = sum(t.astype(np.int64) for t in terms)
        if sub is not None:
            out = out - sub.astype(np.int64)
        return (out % (1 << 32)).astype(np.uint32)

    def seg_min(self, L):
        """The pixel's minimum over its pairs, in both halves."""
        v = L[..., 0]
        for k in range(1, L.shape[-1]):
            v = self.vimin(v, L[..., k])
        return self.vimin(v, self.swap(v))

    def step(self, L, c, p1w, p21w):
        """sgm_step_pairs on a pixel's pairs (..., NP)."""
        m = self.seg_min(L)[..., None]
        sent = np.full(L.shape[:-1] + (1,), self.pair_of(SENT16), np.uint32)
        below = np.concatenate([sent, L[..., :-1]], axis=-1)
        above = np.concatenate([L[..., 1:], sent], axis=-1)
        mq = self.viaddmin(m, p21w, np.uint32(PAIR_MAX))
        nb = self.vimin3(self.shift(below, L), self.shift(L, above), mq)
        best = self.viaddmin(nb, p1w, L)
        return self.add(c, best, sub=np.broadcast_to(m, L.shape))


def packed_b3(cost, acc, p, garbage_seed=0):
    """The 5-path closing launch of the packed route on (B, H, W, D) int16
    cost and horizontal accumulator: (disparity, margin, right-image key
    plane (B, H, W) before the LR check's lookups, the totals (B, H, W, D),
    the Pairs counters)."""
    ops = Pairs()
    cost, acc = (np.asarray(v, dtype=np.int16) for v in (cost, acc))
    b, h, w, d = cost.shape
    md, uniq, lr = (int(p.min_disparity), int(p.uniqueness_ratio),
                    int(p.disp12_max_diff))
    dp = lanes_per_pixel(d) * 4
    n_p = dp // 2
    rng = np.random.default_rng(garbage_seed)

    def ring(v):  # what a lane finds in its ring slot: garbage past D
        junk = rng.integers(-2**15, 2**15, (b, h, w, dp - d)).astype(np.int16)
        return ops.join(np.concatenate([v, junk], -1).reshape(
            b, h, w, n_p, 2))

    cw, aw = ring(cost), ring(acc)
    ds = np.arange(dp)
    keep = ops.join(np.where(ds < d, -1, 0).astype(np.int16).reshape(n_p, 2))
    csent = ops.pair_of(SENT16) & ~keep
    tsent = ops.pair_of(TSENT16) & ~keep
    p1w, p21w = ops.pair_of(int(p.p1)), ops.pair_of(int(p.p2) - int(p.p1))
    zero = np.zeros((b, w, n_p), np.uint32)
    lv, lp, ln = zero, zero, zero  # vertical, dx +1, dx -1
    keys = np.empty((b, h, w, dp), np.int64)
    for t in range(h):
        c = (cw[:, t] & keep) | csent
        from_p = np.concatenate([zero[:, :1], lp[:, :-1]], axis=1)  # x - 1
        from_n = np.concatenate([ln[:, 1:], zero[:, :1]], axis=1)   # x + 1
        lp = ops.step(from_p, c, p1w, p21w)
        ln = ops.step(from_n, c, p1w, p21w)
        lv = ops.step(lv, c, p1w, p21w)
        # past D the sums hold the ring's garbage until the mask
        total = ops.add(aw[:, t], lv, lp, keep=keep)
        total = ops.add(total, ln, keep=keep)
        total = (total & keep) | tsent
        # key: the half's 16 bits above its disparity's byte
        half = ops.halves(total).reshape(b, w, dp).view(np.uint16)
        keys[:, t] = half.astype(np.int64) * 256 + ds
    totals = keys[..., :d] >> 8
    key = keys.min(axis=-1)  # the first minimum wins ties
    d_int = key & 255
    dm1 = np.maximum(d_int - 1, 0)[..., None]
    dp1 = np.minimum(d_int + 1, d - 1)[..., None]
    s_m1 = np.take_along_axis(keys, dm1, -1)[..., 0] >> 8
    s_p1 = np.take_along_axis(keys, dp1, -1)[..., 0] >> 8
    far = np.abs(ds - d_int[..., None]) > 1
    sk = np.where(far, keys, INT_MAX).min(axis=-1) >> 8
    sec = np.where(sk >= TSENT16, stereo._SENT, sk)
    # wta_store's f32 part
    fs, fm1, fp1 = (torch.from_numpy(v.astype(np.float32))
                    for v in (key >> 8, s_m1, s_p1))
    dt = torch.from_numpy(d_int)
    denom = (fm1 + fp1) - 2.0 * fs
    sub = torch.where(denom > 1e-6, (fm1 - fp1) / (2.0 * denom + 1e-12),
                      torch.zeros_like(denom)).clamp(-0.5, 0.5)
    sub = torch.where((dt == 0) | (dt == d - 1), torch.zeros_like(sub), sub)
    dval = (dt.to(torch.float32) + sub) + float(md)
    xs = torch.arange(w)
    valid = (xs >= md + d).expand(b, h, w)
    second = torch.from_numpy(np.where(sec == stereo._SENT, 1e9, sec).astype(
        np.float32))
    if uniq > 0:
        valid = valid & (second * 100.0 >= fs * (100.0 + uniq))
    margin = (second - fs).clamp(min=0.0) / (fs + 1.0)
    disp = torch.where(valid, dval, torch.full_like(dval, float(md - 1)))
    # right image: pixel x votes its key for xr = x - d - md (real d only)
    rkey = np.full((b, h, w), INT_MAX, np.int64)
    for dd in range(d):
        lo = dd + md
        if lo < w:
            np.minimum(rkey[..., :w - lo], keys[..., lo:, dd],
                       out=rkey[..., :w - lo])
    if lr >= 0:  # lr_kernel
        dl = disp - float(md)
        dr = torch.round(dl).long().clamp(0, d - 1)
        at = xs.view(1, 1, w) - md - dr
        d_right = torch.from_numpy(rkey & 255).gather(
            2, at.clamp(min=0)).to(torch.float32)
        ok = (at >= 0) & ((dl - d_right).abs() <= float(lr))
        disp = torch.where((disp >= md) & ~ok,
                           torch.full_like(disp, float(md - 1)), disp)
    return disp, margin, rkey, totals, ops


def twin(cost, acc, p):
    """The int32 twin: (disparity, margin, key plane, totals (B, H, W, D))."""
    ct = torch.from_numpy(cost).permute(0, 1, 3, 2)
    at = torch.from_numpy(acc).permute(0, 1, 3, 2)
    disp, margin = stereo.sgm_vertical_wta_dmajor(ct, at, p,
                                                  return_margin=True)
    total = stereo.sgm_vertical_dmajor(ct, at, p).to(torch.int64)
    total = total.permute(0, 1, 3, 2).numpy()
    b, h, w, d = total.shape
    keys = total * 256 + np.arange(d)
    rkey = np.full((b, h, w), INT_MAX, np.int64)
    for dd in range(d):
        lo = dd + int(p.min_disparity)
        if lo < w:
            np.minimum(rkey[..., :w - lo], keys[..., lo:, dd],
                       out=rkey[..., :w - lo])
    return disp, margin, rkey, total


def _volume(fill, shape, seed):
    r = np.random.default_rng(seed)
    b, h, w, d = shape
    if fill == "random":
        return r.integers(0, COST_MAX + 1, shape).astype(np.int16)
    if fill == "max":
        return np.full(shape, COST_MAX, np.int16)
    if fill == "alternate":  # 0 / cost_max over x, y and d
        g = np.indices(shape).sum(axis=0) % 2
        return (g * COST_MAX).astype(np.int16)
    if fill == "low":  # a narrow range: first and second minima tie often
        return r.integers(0, 3, shape).astype(np.int16)
    raise ValueError(fill)


def _largest_packed_p2(p):
    return max(p2 for p2 in range(0, 2**15)
               if sgm.vertical_route(torch.int16, p.replace(p2=float(p2)))
               == "packed")


@pytest.mark.parametrize("params,dtype,route", [
    (SGBMParams(), torch.int16, "packed"),
    (SGBMParams(num_disparities=16), torch.int16, "packed"),
    (SGBMParams(num_disparities=128), torch.int16, "packed"),
    (SGBMParams(num_paths=8), torch.int16, "int32"),    # f32 accumulator
    (SGBMParams(num_paths=4), torch.int16, "int32"),    # two 1-way launches
    (SGBMParams(num_paths=2), torch.int16, "int32"),    # the WTA alone
    (SGBMParams(p2=4450.0), torch.int16, "int32"),      # past int16 totals
    (SGBMParams(p2=4449.0), torch.int16, "packed"),     # the largest P2
    (SGBMParams(p1=15000.0), torch.int16, "int32"),     # past the sentinel
    (SGBMParams(p1=-1.0), torch.int16, "int32"),
    (SGBMParams(num_disparities=80), torch.int16, "int32"),  # 3 a lane
    (SGBMParams(num_disparities=96), torch.int16, "int32"),
    (SGBMParams(num_disparities=97), torch.int16, "packed"),
    (SGBMParams(), torch.float32, "float"),
    (SGBMParams(), torch.bfloat16, "float"),
], ids=["defaults", "d16", "d128", "paths8", "paths4", "paths2", "p2_4450",
        "p2_4449", "p1_15000", "p1_negative", "d80", "d96", "d97", "f32",
        "bf16"])
def test_vertical_route(params, dtype, route):
    assert sgm.vertical_route(dtype, params) == route


def test_route_bound_holds_at_its_edge():
    """The predicate's inequalities at the largest admitted P2 (4449 at the
    defaults; the int16 accumulator binds first): one path's bound plus
    the larger penalty stays below the sentinel, and the sentinel plus
    both penalties below 2^15."""
    p = SGBMParams()
    p2 = _largest_packed_p2(p)
    assert p2 == 4449
    assert stereo.path_bound(p.replace(p2=float(p2))) + p2 < SENT16
    assert SENT16 + p.p1 + p2 < 2**15


def test_sentinel_matches_the_header():
    text = (_build._SRC_DIR / "sgm_common.cuh").read_text()
    got = re.search(r"constexpr int SENT16 = 1 << (\d+);", text)
    assert got and 1 << int(got.group(1)) == sgm.PACKED_SENT
    assert f"TSENT16 = {TSENT16:#x}" in text


@pytest.mark.parametrize("shape,fill,params", [
    ((2, 7, 33, 64), "random", SGBMParams()),
    ((1, 9, 70, 16), "random", SGBMParams(num_disparities=16)),
    ((1, 6, 41, 48), "random", SGBMParams(num_disparities=48)),
    ((1, 5, 29, 18), "random", SGBMParams(num_disparities=18)),  # part pairs
    ((1, 5, 37, 33), "random", SGBMParams(num_disparities=33)),  # odd D
    ((1, 4, 40, 128), "random", SGBMParams(num_disparities=128)),
    ((1, 6, 35, 32), "random", SGBMParams(num_disparities=32,
                                          min_disparity=3)),
    ((2, 6, 35, 32), "low", SGBMParams(num_disparities=32)),
    ((1, 6, 31, 64), "max", SGBMParams()),
    ((1, 6, 31, 48), "alternate", SGBMParams(num_disparities=48)),
    ((1, 6, 31, 64), "random", SGBMParams(p2=4449.0)),
    ((1, 6, 31, 48), "max", SGBMParams(num_disparities=48, p2=4449.0)),
    ((1, 6, 31, 64), "alternate", SGBMParams(p2=4449.0)),
    ((1, 6, 31, 64), "random", SGBMParams(p1=0.0, p2=0.0)),
    ((1, 6, 31, 64), "random", SGBMParams(p1=3000.0, p2=2000.0)),  # P1 > P2
    ((1, 6, 31, 64), "random", SGBMParams(uniqueness_ratio=0,
                                          disp12_max_diff=-1)),
], ids=["d64", "d16", "d48", "d18", "d33", "d128", "min_d3", "ties", "max",
        "alternate", "p2_max_random", "p2_max_max", "p2_max_alternate",
        "no_penalty", "p1_over_p2", "no_checks"])
def test_packed_route_equals_int32_twin(shape, fill, params):
    """On volumes the route admits, the packed arithmetic wraps nowhere
    (every value a non-negative int16), carries across no half, and gives the twin's totals, disparity,
    margin and right-image keys bit for bit."""
    assert sgm.vertical_route(torch.int16, params) == "packed"
    cost = _volume(fill, shape, seed=sum(shape))
    acc = sgm.horizontal_sweeps_plain(torch.from_numpy(cost),
                                      params).numpy()
    assert acc.dtype == np.int16
    disp, margin, rkey, totals, ops = packed_b3(cost, acc, params)
    w_disp, w_margin, w_rkey, w_total = twin(cost, acc, params)
    assert ops.wraps == 0 and ops.crossings == 0
    np.testing.assert_array_equal(totals, w_total)
    np.testing.assert_array_equal(rkey, w_rkey)
    assert torch.equal(disp, w_disp)
    assert torch.equal(margin, w_margin)


def test_wraps_show_past_the_predicate():
    """With P2 = 17000 a carry past D, up to SENT16 + P2, leaves int16:
    the emulation counts the wraps, and the predicate (whose int16
    accumulator binds first) sends such penalties to the int32 step."""
    p = SGBMParams(num_disparities=48, p2=17000.0)
    assert sgm.vertical_route(torch.int16, p) == "int32"
    cost = _volume("random", (1, 6, 31, 48), seed=5)
    *_, ops = packed_b3(cost, np.zeros_like(cost), p)
    assert ops.wraps > 0


def test_matcher_span_counts_packed_frames_on_the_card_only():
    """The ``matcher.vertical`` span counts the frames of the packed route:
    none where the twins run (CPU)."""
    from torch.profiler import ProfilerActivity, profile

    from video3d_tpu_torch.core import trace

    r = np.random.default_rng(3)
    left = torch.from_numpy(r.uniform(0, 255, (2, 9, 80)).astype(np.float32))
    right = torch.roll(left, -3, dims=2)
    p = SGBMParams(num_disparities=16)
    with profile(activities=[ProfilerActivity.CPU]):
        stereo.sgbm_disparity(left, right, p)
    table = trace.summary()
    assert table["matcher.vertical"]["counts"] == {"packed": 0}
