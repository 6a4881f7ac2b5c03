"""Plain semi-global matcher of the reference: OpenCV StereoSGBM's MODE_SGBM
semantics as the configurations state them, on a (B, H, W, D) volume.

x-Sobel prefilter clipped to the cap and rounded half to even; symmetric
Birchfield-Tomasi cost; a zero-padded block x block box sum rounded half to
even (an integer cost); path sums L = C + min(L', L'(d +- 1) + P1, min L' +
P2) - min L' in exact integers along the two horizontal directions and, for
5 paths, the three downward ones (straight and both diagonals), for 8 paths
those and the three upward ones; winner-take-all on the first minimum with
a parabolic sub-pixel step, the invalid strip x < minD + D, the uniqueness
check and the left-right check against the right image's winners; then the
banded speckle vote. Floating steps run in float64. A disparity that fails
a check is ``min_disparity - 1``.
"""

from __future__ import annotations

import math

import torch

SENT = 1 << 20  # above any path value the integer sums can reach


def prefilter(gray: torch.Tensor, cap: int) -> torch.Tensor:
    """(B, H, W) -> x-Sobel clipped to [-cap, cap], rounded, + cap; edges
    replicate. float64 holding integers."""
    g = gray.to(torch.float64)
    gp = torch.cat([g[:, :1], g, g[:, -1:]], dim=1)
    gp = torch.cat([gp[..., :1], gp, gp[..., -1:]], dim=2)
    h, w = g.shape[1], g.shape[2]

    def win(dy, dx):
        return gp[:, dy:dy + h, dx:dx + w]

    dx = (win(0, 2) - win(0, 0)) + 2.0 * (win(1, 2) - win(1, 0)) + (
        win(2, 2) - win(2, 0))
    return torch.round(dx.clamp(-float(cap), float(cap))) + float(cap)


def _bt_bounds(img: torch.Tensor):
    prev = torch.cat([img[..., :1], img[..., :-1]], dim=-1)
    nxt = torch.cat([img[..., 1:], img[..., -1:]], dim=-1)
    mid_l, mid_r = 0.5 * (img + prev), 0.5 * (img + nxt)
    return (torch.minimum(torch.minimum(mid_l, mid_r), img),
            torch.maximum(torch.maximum(mid_l, mid_r), img))


def _shift_right(img: torch.Tensor, s: int) -> torch.Tensor:
    """img[..., x - s] with the first column replicated."""
    if s == 0:
        return img
    s = min(s, img.shape[-1])
    return torch.cat([img[..., :1].expand(*img.shape[:-1], s),
                      img[..., :img.shape[-1] - s]], dim=-1)


def _box_zero(x: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-padded k x k window sum over the last two axes of (B, H, W)."""
    p = k // 2
    h, w = x.shape[-2], x.shape[-1]
    xp = torch.nn.functional.pad(x, (p, p, p, p))
    v = sum(xp[..., i:i + h, :] for i in range(k))
    return sum(v[..., j:j + w] for j in range(k))


def cost_volume(lf: torch.Tensor, rf: torch.Tensor, params: dict,
                raw_invalid: float) -> torch.Tensor:
    """Prefiltered eyes (B, H, W) -> int16 cost (B, H, W, D): BT cost of
    left x against right x - (minD + d), ``raw_invalid`` outside the right
    image, box-summed and rounded half to even."""
    b, h, w = lf.shape
    nd, md = params["num_disparities"], params["min_disparity"]
    l_lo, l_hi = _bt_bounds(lf)
    r_lo, r_hi = _bt_bounds(rf)
    xs = torch.arange(w, device=lf.device)
    out = torch.empty((b, h, w, nd), dtype=torch.int16, device=lf.device)
    for d in range(nd):
        s = d + md
        r, rlo, rhi = (_shift_right(t, s) for t in (rf, r_lo, r_hi))
        cost = torch.minimum(
            torch.clamp(torch.maximum(lf - rhi, rlo - lf), min=0.0),
            torch.clamp(torch.maximum(r - l_hi, l_lo - r), min=0.0))
        cost = torch.where(xs < s, float(raw_invalid), cost)
        out[..., d] = torch.round(_box_zero(cost, params["block_size"])
                                  ).to(torch.int16)
    return out


def _step(prev: torch.Tensor, c: torch.Tensor, p1: int, p2: int):
    """One path step over the last (disparity) axis, int32."""
    m = prev.amin(dim=-1, keepdim=True)
    edge = torch.full_like(prev[..., :1], SENT)
    up = torch.cat([prev[..., 1:], edge], dim=-1)
    dn = torch.cat([edge, prev[..., :-1]], dim=-1)
    best = torch.minimum(torch.minimum(prev, m + p2),
                         torch.minimum(up, dn) + p1)
    return c + best - m


def _lateral(prev: torch.Tensor, s: int) -> torch.Tensor:
    """Carry of a diagonal path over (B, W, D): the value at x - s, zero
    past the edge."""
    if s == 0:
        return prev
    zero = torch.zeros_like(prev[:, :1])
    if s > 0:
        return torch.cat([zero, prev[:, :-1]], dim=1)
    return torch.cat([prev[:, 1:], zero], dim=1)


def path_total(cost: torch.Tensor, params: dict) -> torch.Tensor:
    """Sum of the mode's path costs, int32 (B, H, W, D)."""
    p1, p2 = int(params["p1"]), int(params["p2"])
    if (p1, p2) != (params["p1"], params["p2"]):
        raise ValueError("integer path sums need whole penalties")
    c32 = cost.to(torch.int32)
    b, h, w, nd = cost.shape
    total = torch.zeros_like(c32)
    for xs in (range(w), range(w - 1, -1, -1)):  # horizontal paths
        carry = torch.zeros((b, h, nd), dtype=torch.int32, device=cost.device)
        for x in xs:
            carry = _step(carry, c32[:, :, x], p1, p2)
            total[:, :, x] += carry
    shifts = {2: (), 4: (0,), 5: (0, 1, -1), 8: (0, 1, -1)}[
        params["num_paths"]]
    ys = [range(h)] if params["num_paths"] == 5 else [range(h),
                                                       range(h - 1, -1, -1)]
    for rows in (ys if shifts else []):
        carries = [torch.zeros((b, w, nd), dtype=torch.int32,
                               device=cost.device) for _ in shifts]
        for y in rows:
            for k, s in enumerate(shifts):
                carries[k] = _step(_lateral(carries[k], s), c32[:, y], p1, p2)
                total[:, y] += carries[k]
    return total


def winner(total: torch.Tensor, params: dict):
    """Winner-take-all on the path total (B, H, W, D) int32 -> (disparity
    float64 (B, H, W), uniqueness margin float64)."""
    b, h, w, nd = total.shape
    md = params["min_disparity"]
    dev = total.device
    s_min = total.amin(dim=-1, keepdim=True)
    iota = torch.arange(nd, dtype=torch.int32, device=dev)
    d_int = torch.where(total == s_min, iota, nd).amin(dim=-1)
    s_min = s_min[..., 0].to(torch.float64)
    sel = d_int.unsqueeze(-1).long()
    fm1 = torch.gather(total, -1, (sel - 1).clamp(min=0))[..., 0].double()
    fp1 = torch.gather(total, -1, (sel + 1).clamp(max=nd - 1))[..., 0].double()
    denom = fm1 + fp1 - 2.0 * s_min
    sub = torch.where(denom > 1e-6, (fm1 - fp1) / (2.0 * denom + 1e-12), 0.0)
    sub = torch.where((d_int == 0) | (d_int == nd - 1), 0.0,
                      sub.clamp(-0.5, 0.5))
    disp = d_int.double() + sub + md
    valid = (torch.arange(w, device=dev) >= md + nd).expand(b, h, w)
    near = (iota - d_int.unsqueeze(-1)).abs() <= 1
    second = torch.where(near, SENT, total).amin(dim=-1)
    second = torch.where(second == SENT, 1e9, second.double())
    if params["uniqueness_ratio"] > 0:
        valid = valid & (second * 100.0
                         >= s_min * (100.0 + params["uniqueness_ratio"]))
    margin = (second - s_min).clamp(min=0.0) / (s_min + 1.0)
    if params["disp12_max_diff"] >= 0:
        # right-image winners: first minimum over d of total[x_r + d + md, d]
        best = torch.full((b, h, w), SENT, dtype=torch.int32, device=dev)
        d_right = torch.zeros((b, h, w), dtype=torch.int64, device=dev)
        for d in range(nd):
            s = d + md
            plane = torch.full((b, h, w), SENT, dtype=torch.int32, device=dev)
            if s < w:
                plane[..., :w - s] = total[:, :, s:, d]
            better = plane < best
            best = torch.where(better, plane, best)
            d_right = torch.where(better, d, d_right)
        dl = disp - md
        xr = (torch.arange(w, device=dev) - md
              - torch.round(dl).long().clamp(0, nd - 1))
        at = torch.gather(d_right, 2, xr.clamp(min=0)).double()
        valid = valid & (xr >= 0) & ((dl - at).abs()
                                     <= params["disp12_max_diff"])
    return torch.where(valid, disp, float(md - 1)), margin


def box_clipped(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sum over the border-clipped (2r+1)^2 window of the last two axes."""
    for axis in (-2, -1):
        n = x.shape[axis]
        rr = min(r, n - 1)
        if rr <= 0:
            continue
        c = torch.cumsum(x, dim=axis)
        zeros = torch.zeros_like(c.narrow(axis, 0, 1))
        c = torch.cat([zeros, c], dim=axis)  # c[i] = sum of x[:i]
        idx = torch.arange(n, device=x.device)
        hi = (idx + rr + 1).clamp(max=n)
        lo = (idx - rr).clamp(min=0)
        x = c.index_select(axis, hi) - c.index_select(axis, lo)
    return x


def speckle(disp: torch.Tensor, params: dict) -> torch.Tensor:
    """Banded speckle vote: a valid pixel stays if at least
    ``speckle_window_size`` valid pixels of its band or an adjacent one
    (bands ``speckle_range`` wide over [minD, minD + D]) lie in its clipped
    window of radius max(2, ceil(sqrt(size)))."""
    size = params["speckle_window_size"]
    if size <= 0:
        return disp
    md, nd = params["min_disparity"], params["num_disparities"]
    step = float(params["speckle_range"])
    radius = max(2, int(math.ceil(math.sqrt(float(size)))))
    n_bands = max(1, int(math.ceil(nd / step))) + 1
    invalid = float(md - 1)
    valid = disp != invalid
    band = torch.floor((disp - md) / step).long().clamp(0, n_bands - 1)
    counts = [box_clipped(((band == k) & valid).double(), radius)
              for k in range(n_bands)]
    support = torch.zeros_like(disp)
    for k in range(n_bands):
        s = counts[k]
        if k > 0:
            s = s + counts[k - 1]
        if k < n_bands - 1:
            s = s + counts[k + 1]
        support = torch.where(band == k, s, support)
    return torch.where(valid & (support >= size), disp, invalid)


def confidence(margin: torch.Tensor, lf: torch.Tensor,
               cap: int) -> torch.Tensor:
    """Texture-gated match confidence in [0, 1]: the squashed uniqueness
    margin (mid 0.5) times the squashed mean |x-Sobel| in a clipped 5x5
    window (mid 8)."""
    e = (lf - float(cap)).abs()
    area = box_clipped(torch.ones_like(e[:1]), 2)
    texture = box_clipped(e, 2) / area
    mm, tt = margin * margin, texture * texture
    return mm / (mm + 0.25) * tt / (tt + 64.0)


def disparity(gl: torch.Tensor, gr: torch.Tensor, params: dict,
              want_confidence: bool, apply_speckle: bool = True):
    """Gray eyes (B, H, W) -> disparity (B, H, W) float64, and the match
    confidence with ``want_confidence``."""
    cap = params["prefilter_cap"]
    lf, rf = prefilter(gl, cap), prefilter(gr, cap)
    # out-of-frame matches cost the largest per-pixel cost; the invalid
    # strip keeps them out of the result
    cost = cost_volume(lf, rf, params, 2.0 * cap)
    disp, margin = winner(path_total(cost, params), params)
    del cost
    if apply_speckle:
        disp = speckle(disp, params)
    if want_confidence:
        return disp, confidence(margin, lf, cap)
    return disp
