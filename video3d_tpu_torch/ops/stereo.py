"""Semi-global stereo matching: numeric contract, plain twins, dispatcher.

Counterpart of :mod:`video3d_tpu.ops.stereo` for the int16 formulation
the TPU path ships (``ops/stereo.py:655-722`` there): x-Sobel prefilter,
symmetric Birchfield-Tomasi cost, 5x5 zero-padded box sum rounded half to
even into int16, the SGM path sweeps of OpenCV's modes (2 paths: the two
horizontals; 4: + vertical both ways; 5, MODE_SGBM: + the three downward
directions; 8, MODE_HH: + vertical and both diagonals both ways, the last
sweep bottom-up), winner-take-all with sub-pixel refinement, uniqueness
and left-right checks, and the banded speckle vote. The accumulator is
int16 where the path total provably fits (:func:`acc_dtype_for_params`)
and f32 otherwise (8 paths at the defaults), as in the JAX package.

The plain twins here keep the JAX package's D-major ``(B, H, D, W)``
layout at their signatures, so tests compare like with like, except
:func:`sgm_aggregate`, which keeps the ``(B, H, W, D)`` of the JAX
function of that name. The kernels (:mod:`video3d_tpu_torch.kernels`)
keep the volume as ``(B, H, W, D)`` between themselves; their wrappers
pick the CUDA kernel for a CUDA tensor and the twin for a CPU tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from video3d_tpu_torch.core.trace import span

BIG = 1e9  # carry sentinel of the float sweeps
# int16 accumulator bound: every 5-path total at the defaults stays below
# it (see acc_dtype_for_params), so int16 accumulation is exact
BIG_I16 = 30000
# carry sentinel of the integer sweeps: above any reachable path value
# (integer path totals must stay below it: check_integer_totals)
_SENT = 1 << 20


@dataclasses.dataclass(frozen=True)
class SGBMParams:
    """Matcher configuration; a copy of the JAX package's ``SGBMParams``
    (defaults mirror the reference depth.py:315-325), pinned equal by
    test."""

    min_disparity: int = 0
    num_disparities: int = 64
    block_size: int = 5
    p1: float = 600.0
    p2: float = 2400.0
    disp12_max_diff: int = 1
    uniqueness_ratio: int = 10
    speckle_window_size: int = 100
    speckle_range: int = 32
    prefilter_cap: int = 31
    # 2 = horizontal; 4 = + vertical; 5 = horizontals + downward-only
    # vertical/diagonals (OpenCV MODE_SGBM); 8 = all (MODE_HH)
    num_paths: int = 5

    def replace(self, **kw) -> "SGBMParams":
        return dataclasses.replace(self, **kw)


def INVALID(p: SGBMParams) -> float:
    """Value of an invalidated pixel: ``min_disparity - 1``."""
    return float(p.min_disparity - 1)


def sgbm_params_from_jax(d: dict) -> SGBMParams:
    """Port params from ``dataclasses.asdict`` of the JAX ``SGBMParams``."""
    names = {f.name for f in dataclasses.fields(SGBMParams)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown SGBMParams fields: {sorted(unknown)}")
    return SGBMParams(**d)


def acc_dtype_for_params(cost_dtype: torch.dtype,
                         params: SGBMParams) -> torch.dtype:
    """Accumulator dtype that provably cannot overflow for ``params``.

    One direction's path value is at most cost_max + P2, cost_max =
    block**2 * 2 * prefilter_cap; the total is num_paths times that.
    int16 is exact iff that total stays below BIG_I16 (5-path defaults:
    5 * (1550 + 2400) = 19750); otherwise f32, which holds every integer
    total exactly (8-path MODE_HH at the defaults: 31600).
    """
    if cost_dtype.is_floating_point:
        return torch.float32
    return (torch.int16 if path_total_bound(params) < BIG_I16
            else torch.float32)


def path_bound(params: SGBMParams) -> float:
    """Largest value one direction's path reaches on an integer cost volume
    of ``params``: cost_max + P2."""
    return params.block_size**2 * 2 * params.prefilter_cap + params.p2


def path_total_bound(params: SGBMParams) -> int:
    """Largest path total an integer cost volume of ``params`` can reach."""
    return int(params.num_paths * path_bound(params))


def check_integer_totals(params: SGBMParams) -> None:
    """Raise where an integer path total could reach the sweeps' sentinel
    (the integer twins and kernels compare against it)."""
    if path_total_bound(params) >= _SENT:
        raise ValueError(
            f"SGM path totals up to {path_total_bound(params)} reach the "
            f"integer sentinel {_SENT}: lower p2 or num_paths")


# ---------------------------------------------------------------------------
# Cost volume (plain twin of kernel B1)
# ---------------------------------------------------------------------------


def xsobel_clip(gray: torch.Tensor, cap: int) -> torch.Tensor:
    """Horizontal Sobel derivative, clipped to [-cap, cap], rounded half to
    even and shifted to [0, 2*cap]; edges replicate. (..., H, W) f32."""
    g = gray.to(torch.float32)
    gp = torch.cat([g[..., :1, :], g, g[..., -1:, :]], dim=-2)
    gp = torch.cat([gp[..., :1], gp, gp[..., -1:]], dim=-1)
    h, w = g.shape[-2], g.shape[-1]

    def win(dy, dx):
        return gp[..., dy:dy + h, dx:dx + w]

    dx = (win(0, 2) - win(0, 0)) + 2.0 * (win(1, 2) - win(1, 0)) + (
        win(2, 2) - win(2, 0))
    return torch.round(torch.clamp(dx, -float(cap), float(cap))) + float(cap)


def _bt_bounds(img: torch.Tensor):
    """Birchfield-Tomasi half-sample lower/upper envelopes along width."""
    prev = torch.cat([img[..., :1], img[..., :-1]], dim=-1)
    nxt = torch.cat([img[..., 1:], img[..., -1:]], dim=-1)
    mid_l = 0.5 * (img + prev)
    mid_r = 0.5 * (img + nxt)
    lo = torch.minimum(torch.minimum(mid_l, mid_r), img)
    hi = torch.maximum(torch.maximum(mid_l, mid_r), img)
    return lo, hi


def bt_cost_volume_dmajor(
    left: torch.Tensor,
    right: torch.Tensor,
    num_disparities: int,
    min_disparity: int = 0,
    raw_invalid: float = BIG,
) -> torch.Tensor:
    """BT cost volume, D-major: (..., H, W) -> (..., H, D, W).

    ``cost[..., d, x]`` compares left x with right ``x - (min_disparity +
    d)``; matches outside the right image cost ``raw_invalid``.
    """
    l_lo, l_hi = _bt_bounds(left)
    r_lo, r_hi = _bt_bounds(right)
    w = left.shape[-1]
    xs = torch.arange(w, device=left.device)

    def shift_right(img, s):
        if s == 0:
            return img
        s = min(s, w)
        edge = img[..., :1].expand(*img.shape[:-1], s)
        return torch.cat([edge, img[..., :w - s]], dim=-1)

    slices = []
    for d in range(num_disparities):
        shift = d + min_disparity
        r = shift_right(right, shift)
        rlo = shift_right(r_lo, shift)
        rhi = shift_right(r_hi, shift)
        d_lr = torch.clamp(torch.maximum(left - rhi, rlo - left), min=0.0)
        d_rl = torch.clamp(torch.maximum(r - l_hi, l_lo - r), min=0.0)
        cost = torch.minimum(d_lr, d_rl)
        cost = torch.where(xs - shift < 0,
                           torch.full_like(cost, float(raw_invalid)), cost)
        slices.append(cost)
    return torch.stack(slices, dim=-2)


def box_aggregate_hw(cost: torch.Tensor, block_size: int) -> torch.Tensor:
    """Zero-padded block_size x block_size window sum over the H (axis -3)
    and W (axis -1) of (..., H, D, W)."""
    if block_size <= 1:
        return cost
    pad = block_size // 2
    h, w = cost.shape[-3], cost.shape[-1]
    zh = torch.zeros_like(cost[..., :1, :, :]).expand(
        *cost.shape[:-3], pad, cost.shape[-2], w)
    vp = torch.cat([zh, cost, zh], dim=-3)
    vsum = vp[..., 0:h, :, :]
    for k in range(1, block_size):
        vsum = vsum + vp[..., k:k + h, :, :]
    zw = torch.zeros_like(vsum[..., :1]).expand(*vsum.shape[:-1], pad)
    hp = torch.cat([zw, vsum, zw], dim=-1)
    out = hp[..., 0:w]
    for k in range(1, block_size):
        out = out + hp[..., k:k + w]
    return out


def cost_volume_dmajor(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    params: SGBMParams,
    raw_invalid: float,
    return_filtered_left: bool = False,
):
    """Plain twin of B1: raw gray pair (B, H, W) -> int16 (B, H, D, W).

    x-Sobel prefilter, BT cost, box sum, round half to even -- the
    semantics of the JAX ``fused_cost_volume(..., out_dtype=int16,
    prefilter_cap=cap)``. With ``return_filtered_left`` also returns the
    prefiltered left view as int16 (B, H, W).
    """
    lf = xsobel_clip(left_gray, params.prefilter_cap)
    rf = xsobel_clip(right_gray, params.prefilter_cap)
    cost = bt_cost_volume_dmajor(lf, rf, params.num_disparities,
                                 params.min_disparity, raw_invalid)
    cost = torch.round(box_aggregate_hw(cost, params.block_size))
    cost = cost.to(torch.int16)
    if return_filtered_left:
        return cost, lf.to(torch.int16)
    return cost


# ---------------------------------------------------------------------------
# SGM sweeps (plain twins of kernels B2, B3 and B8a)
# ---------------------------------------------------------------------------

# the matcher's horizontal routes: the (B, W, D, H) sweeps of B2, or the
# W-major (B, D, W, H) sweeps of B8c behind torch permutes ("xla") or the
# B8b transposes ("mxu"); the JAX package's VIDEO3D_TPU_SGM_TRANSPOSE
HORIZONTAL_ROUTES = ("legacy", "xla", "mxu")


def vertical_shifts(num_paths: int) -> tuple:
    """Lateral shifts of the vertical sweeps of an SGM mode: none for 2
    paths, the vertical (0,) for 4, the vertical and both diagonals for 5
    (top-down only, OpenCV MODE_SGBM) and 8 (both ways, MODE_HH)."""
    shifts = {2: (), 4: (0,), 5: (0, 1, -1), 8: (0, 1, -1)}
    if num_paths not in shifts:
        raise ValueError(f"num_paths must be 2, 4, 5 or 8: {num_paths}")
    return shifts[num_paths]


def vertical_directions(num_paths: int) -> tuple:
    """(dy, dx) steps of the vertical sweeps in the TPU kernels' order:
    top-down (dy 1) with each shift of :func:`vertical_shifts`, then, for
    4 and 8 paths, bottom-up (dy -1); dx 1 follows the pixel at x - 1."""
    shifts = vertical_shifts(num_paths)
    dys = (1,) if num_paths == 5 else (1, -1)
    return tuple((dy, dx) for dy in dys for dx in shifts)


def _shift_lateral(prev: torch.Tensor, s: int) -> torch.Tensor:
    """Carry of a diagonal path: value from W index x - s, zero-filled."""
    if s == 0:
        return prev
    zero = torch.zeros_like(prev[..., :1])
    if s > 0:
        return torch.cat([zero, prev[..., :-1]], dim=-1)
    return torch.cat([prev[..., 1:], zero], dim=-1)


def _sgm_step(prev: torch.Tensor, c: torch.Tensor, p1, p2,
              sent) -> torch.Tensor:
    """L = C + min(L', L'(d+-1) + P1, min L' + P2) - min L' over axis 1
    of (B, D, W), with ``sent`` past both ends of d."""
    m = prev.amin(dim=1, keepdim=True)
    edge = torch.full_like(prev[:, :1], sent)
    up = torch.cat([prev[:, 1:], edge], dim=1)
    dn = torch.cat([edge, prev[:, :-1]], dim=1)
    best = torch.minimum(torch.minimum(prev, m + p2),
                         torch.minimum(up, dn) + p1)
    return c + best - m


def integral_penalties(p1: float, p2: float) -> tuple:
    """(P1, P2) as ints; the integer sweeps are exact only for whole
    penalties."""
    if float(p1) != int(p1) or float(p2) != int(p2):
        raise ValueError(f"integer SGM needs whole penalties: {p1}, {p2}")
    return int(p1), int(p2)


def sgm_sweep_dmajor(
    cost: torch.Tensor,
    acc,
    shifts: tuple,
    p1: float,
    p2: float,
    reverse: bool,
    acc_dtype: torch.dtype = torch.int16,
) -> torch.Tensor:
    """Plain twin of B2 (JAX ``_directional_pass_dmajor``) and of the
    sweeps of B8a (``_directional_pass``).

    Sweeps over axis 1 (scan lines) of the (B, R, D, W) ``cost`` for each
    lateral shift in ``shifts`` (0 straight, +-1 diagonal), carries starting
    at zero, and adds every direction's path values into ``acc`` (a fresh
    accumulation of ``acc_dtype`` when None) in the order of ``shifts``.
    An integer cost sweeps in int32 with whole penalties, exact into an
    int16 or f32 accumulator; a float cost (f32 or bf16) in f32 with the
    1e9 sentinel and the TPU kernel's order of operations, into f32.
    """
    if cost.dtype.is_floating_point:
        ct, sent = torch.float32, BIG
        p1, p2 = float(p1), float(p2)
    else:
        ct, sent = torch.int32, _SENT
        p1, p2 = integral_penalties(p1, p2)
    out_dtype = acc.dtype if acc is not None else acc_dtype
    if ct == torch.float32 and out_dtype != torch.float32:
        raise ValueError("a float cost sweeps into an f32 accumulator")
    b, r, d, w = cost.shape
    out = torch.empty(cost.shape, dtype=out_dtype, device=cost.device)
    carries = [torch.zeros((b, d, w), dtype=ct, device=cost.device)
               for _ in shifts]
    for y in (range(r - 1, -1, -1) if reverse else range(r)):
        c = cost[:, y].to(ct)
        total = acc[:, y].to(ct) if acc is not None else torch.zeros_like(c)
        for k, s in enumerate(shifts):
            carries[k] = _sgm_step(_shift_lateral(carries[k], s), c, p1, p2,
                                   sent)
            total = total + carries[k]
        out[:, y] = total.to(out.dtype)
    return out


def sgm_vertical_dmajor(cost: torch.Tensor, acc: torch.Tensor,
                        params: SGBMParams) -> torch.Tensor:
    """The vertical sweeps of ``params.num_paths`` over (B, H, D, W) added
    to ``acc``, in the TPU kernels' order: top-down with the shifts of
    :func:`vertical_shifts`, then, for 4 and 8 paths, the same bottom-up
    (the closing sweep)."""
    shifts = vertical_shifts(params.num_paths)
    if not shifts:
        return acc
    total = sgm_sweep_dmajor(cost, acc, shifts, params.p1, params.p2, False)
    if params.num_paths != 5:
        total = sgm_sweep_dmajor(cost, total, shifts, params.p1, params.p2,
                                 True)
    return total


def sgm_aggregate(cost: torch.Tensor, params: SGBMParams) -> torch.Tensor:
    """Plain twin of B8a (JAX ``sgm_aggregate_pallas``; the JAX function
    of this name computes the same sums in another order): the sum of the
    ``params.num_paths`` directional path costs of a (B, H, W, D) f32 or
    bf16 cost, as f32 (B, H, W, D).

    Direction by direction in the TPU kernel's order: the horizontal
    sweeps (left to right, then right to left), then
    :func:`sgm_vertical_dmajor`.
    """
    if not cost.dtype.is_floating_point:
        raise ValueError(f"sgm_aggregate takes an f32 or bf16 cost: "
                         f"{cost.dtype}")
    vertical_shifts(params.num_paths)
    cost_t = cost.permute(0, 2, 3, 1)  # (B, W, D, H): scan lines along W
    acc_t = sgm_sweep_dmajor(cost_t, None, (0,), params.p1, params.p2, False,
                             torch.float32)
    acc_t = sgm_sweep_dmajor(cost_t, acc_t, (0,), params.p1, params.p2, True)
    acc = sgm_vertical_dmajor(cost.permute(0, 1, 3, 2),
                              acc_t.permute(0, 3, 2, 1), params)
    return acc.permute(0, 1, 3, 2).contiguous()


def wta_total_dmajor(total: torch.Tensor, params: SGBMParams,
                     return_margin: bool = False):
    """Winner-take-all on the complete path total (B, H, D, W): int16, or
    f32 holding integers (the f32 accumulator of an integer cost, exact in
    int32).

    Semantics of the JAX ``_final_wta_kernel_dmajor``: first minimum,
    parabolic sub-pixel step in f32 (clipped to +-0.5, zero at both ends
    of d), invalid strip x < minD + D, uniqueness against the best cost
    outside d+-1, and the LR check against the right-image WTA of the same
    total. Invalid pixels are ``min_disparity - 1``.
    """
    b, h, nd, w = total.shape
    md = int(params.min_disparity)
    dev = total.device
    t = total.to(torch.int32)
    s_min, _ = t.min(dim=2, keepdim=True)
    iota = torch.arange(nd, dtype=torch.int32, device=dev).view(1, 1, nd, 1)
    d_int = torch.where(t == s_min, iota, nd).amin(dim=2)  # first minimum
    s_min = s_min[:, :, 0]
    dn_t = torch.cat([t[:, :, :1], t[:, :, :-1]], dim=2)
    up_t = torch.cat([t[:, :, 1:], t[:, :, -1:]], dim=2)
    sel = d_int.unsqueeze(2).long()
    fs = s_min.to(torch.float32)
    fm1 = torch.gather(dn_t, 2, sel)[:, :, 0].to(torch.float32)
    fp1 = torch.gather(up_t, 2, sel)[:, :, 0].to(torch.float32)
    denom = fm1 + fp1 - 2.0 * fs
    sub = torch.where(denom > 1e-6, (fm1 - fp1) / (2.0 * denom + 1e-12),
                      torch.zeros_like(denom))
    sub = torch.clamp(sub, -0.5, 0.5)
    sub = torch.where((d_int == 0) | (d_int == nd - 1),
                      torch.zeros_like(sub), sub)
    disp = d_int.to(torch.float32) + sub + float(md)

    xs = torch.arange(w, device=dev)
    valid = (xs >= md + nd).view(1, 1, w).expand(b, h, w)

    near = (iota - sel).abs() <= 1
    second_i = torch.where(near, _SENT, t).amin(dim=2)
    second = torch.where(second_i == _SENT, torch.full_like(fs, BIG),
                         second_i.to(torch.float32))
    if params.uniqueness_ratio > 0:
        valid = valid & (second * 100.0
                         >= fs * (100.0 + params.uniqueness_ratio))
    margin = torch.clamp(second - fs, min=0.0) / (fs + 1.0)

    if params.disp12_max_diff >= 0:
        # right-image WTA: first minimum over d of total[d, xr + d + md]
        best = torch.full((b, h, w), _SENT, dtype=torch.int32, device=dev)
        d_right = torch.zeros((b, h, w), dtype=torch.int64, device=dev)
        for dd in range(nd):
            shift = dd + md
            plane = torch.full((b, h, w), _SENT, dtype=torch.int32,
                               device=dev)
            if shift < w:
                plane[..., :w - shift] = t[:, :, dd, shift:]
            better = plane < best
            best = torch.where(better, plane, best)
            d_right = torch.where(better, dd, d_right)
        dl = disp - float(md)
        d_round = torch.clamp(torch.round(dl).to(torch.int64), 0, nd - 1)
        xr = xs.view(1, 1, w) - md - d_round
        at = torch.gather(d_right, 2, xr.clamp(min=0)).to(torch.float32)
        lr_ok = (xr >= 0) & ((dl - at).abs()
                             <= float(params.disp12_max_diff))
        valid = valid & lr_ok

    out = torch.where(valid, disp, torch.full_like(disp, INVALID(params)))
    if return_margin:
        return out, margin
    return out


def sgm_vertical_wta_dmajor(cost: torch.Tensor, acc: torch.Tensor,
                            params: SGBMParams, return_margin: bool = False):
    """Plain twin of B3 (JAX ``sgm_wta_pallas_dmajor`` after its
    horizontal passes): the vertical sweeps of :func:`sgm_vertical_dmajor`
    added to the horizontal ``acc`` of (B, H, D, W) ``cost``, then WTA;
    2 paths is plain WTA of ``acc``."""
    return wta_total_dmajor(sgm_vertical_dmajor(cost, acc, params), params,
                            return_margin=return_margin)


# ---------------------------------------------------------------------------
# Full matcher
# ---------------------------------------------------------------------------


def match_confidence(margin: torch.Tensor, texture: torch.Tensor,
                     margin_mid: float = 0.5,
                     texture_mid: float = 8.0) -> torch.Tensor:
    """Per-pixel match confidence in [0, 1]: squashed uniqueness margin
    times squashed texture energy (JAX ``match_confidence``)."""
    mm = margin * margin
    conf = mm / (mm + float(margin_mid) * float(margin_mid))
    tt = texture * texture
    return conf * tt / (tt + float(texture_mid) * float(texture_mid))


def texture_energy(lf: torch.Tensor, cap: int, radius: int = 2) -> torch.Tensor:
    """Windowed mean |x-sobel| response from the prefiltered view."""
    from video3d_tpu_torch.ops.boxsum import box_sum_2d, window_area

    e = torch.abs(lf - float(cap))
    h, w = e.shape[-2], e.shape[-1]
    return box_sum_2d(e, radius) / window_area(h, w, radius, device=e.device)


def sgbm_disparity(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    params: SGBMParams = SGBMParams(),
    apply_speckle: bool = True,
    return_margin: bool = False,
    horizontal_route: str = "legacy",
):
    """Full semi-global matcher: (B, H, W) gray pair -> float disparity.

    Cost volume (B1) -> forward and backward horizontal sweeps (B2, or B8c
    on the W-major volume) -> the vertical sweeps of ``params.num_paths``
    and WTA (B3) -> speckle vote (B4), on any width. The accumulator is
    int16 or f32 by :func:`acc_dtype_for_params`. ``horizontal_route``
    (:data:`HORIZONTAL_ROUTES`) picks the horizontal sweeps' layout, as the
    JAX package's ``VIDEO3D_TPU_SGM_TRANSPOSE``; every route gives the same
    disparities. CUDA tensors run the kernels, CPU tensors their plain
    twins. ``return_margin`` also returns the texture-gated match
    confidence, as the JAX function does. Each step is a ``matcher.*``
    span (:mod:`video3d_tpu_torch.core.trace`).
    """
    from video3d_tpu_torch.kernels import costvol, sgm, speckle, wmajor

    if params.min_disparity < 0:
        raise NotImplementedError("negative min_disparity is not yet ported")
    if horizontal_route not in HORIZONTAL_ROUTES:
        raise ValueError(f"horizontal_route must be one of "
                         f"{HORIZONTAL_ROUTES}: {horizontal_route!r}")
    vertical_shifts(params.num_paths)
    check_integer_totals(params)
    # sentinel-free int16 cost: out-of-frame matches cost the max valid
    # per-pixel cost; the WTA strip mask keeps them invalid
    raw_invalid = 2.0 * params.prefilter_cap
    with span("matcher.cost", left_gray):
        res = costvol.cost_volume(left_gray, right_gray, params, raw_invalid,
                                  return_filtered_left=return_margin)
    cost, lf = res if return_margin else (res, None)
    with span("matcher.horizontal", left_gray):
        if horizontal_route == "legacy":
            acc = sgm.horizontal_sweeps(cost, params)
        else:
            acc = wmajor.horizontal_sweeps_wmajor(cost, params,
                                                  horizontal_route)
    # packed: the frames whose B3 runs on packed 16-bit pairs
    packed = (cost.shape[0] if cost.is_cuda and sgm.vertical_route(
        cost.dtype, params) == "packed" else 0)
    with span("matcher.vertical", left_gray, packed=packed):
        res = sgm.vertical_sweeps_wta(cost, acc, params,
                                      return_margin=return_margin)
    disp, margin = res if return_margin else (res, None)
    if apply_speckle and params.speckle_window_size > 0:
        with span("matcher.speckle", left_gray):
            disp = speckle.speckle_filter(
                disp,
                invalid=INVALID(params),
                max_diff=float(params.speckle_range),
                min_region=params.speckle_window_size,
                value_range=(float(params.min_disparity),
                             float(params.min_disparity
                                   + params.num_disparities)),
            )
    if return_margin:
        with span("matcher.confidence", left_gray):
            conf = match_confidence(
                margin, texture_energy(lf.to(torch.float32),
                                       params.prefilter_cap))
        return disp, conf
    return disp
