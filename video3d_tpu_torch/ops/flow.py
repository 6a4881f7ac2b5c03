"""Dense optical flow and the flow-guided temporal depth smoother.

Counterpart of :mod:`video3d_tpu.ops.flow`: a causal exponential moving
average carried along the motion field. Motion is estimated coarse to
fine on a reduced-resolution gray guide by block matching over a static
candidate grid with a softargmin sub-pixel update; the previous smoothed
depth is warped along it and blended with the current frame, gated by a
photometric and a depth residual so scene cuts and occlusions pass the
current frame through.

Two entries dispatch to hand-written CUDA kernels for a CUDA tensor and
to plain twins here for a CPU tensor:

* :func:`flow_level`, one pyramid level step (the incoming flow's
  upsample, its clamp, the shift warp and the match, softargmin and
  residual smoothing in one launch), kernel B6 (:mod:`video3d_tpu_torch.
  kernels.flowmatch`), twin :func:`flow_level_plain`;
* :func:`ema_tail`, the full-resolution EMA step after the flow (the
  guide residual, the warp of the previous smoothed depth along the
  upsampled flow, the depth gate and the blend), kernel B5's EMA launches
  (:mod:`video3d_tpu_torch.kernels.warp`), twin :func:`ema_tail_plain`.

The twins are compositions of :func:`warp_bilinear_shifts_plain` and
:func:`flow_match_plain`, the plain twins of the public kernels
``kernels.warp.warp_bilinear_shifts`` and ``kernels.flowmatch.flow_match``.

The recurrence over frames is a plain loop; its carry stays on the
device. Flow convention, as in the JAX package: ``cur(x) ~= prev(x +
flow(x))`` (backward flow).

The gather estimator (:func:`warp_bilinear`, :func:`estimate_flow`) is
ported in plain torch for completeness; only tests use it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from video3d_tpu_torch.ops.boxsum import box_sum_2d, window_area
from video3d_tpu_torch.ops.image import resize2d


@lru_cache(maxsize=32)
def _area(h: int, w: int, r: int, device: torch.device) -> torch.Tensor:
    """Border-clipped window area, computed once per shape and device."""
    return window_area(h, w, r, device=device)


def _shift_axis(img: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    n = img.shape[dim]
    k = max(-n, min(k, n))
    if k == 0:
        return img
    edge_size = list(img.shape)
    edge_size[dim] = abs(k)
    if k > 0:
        edge = img.narrow(dim, n - 1, 1).expand(edge_size)
        return torch.cat([img.narrow(dim, k, n - k), edge], dim=dim)
    edge = img.narrow(dim, 0, 1).expand(edge_size)
    return torch.cat([edge, img.narrow(dim, 0, n + k)], dim=dim)


def shift_edge(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = img[..., y+dy, x+dx], edge-replicated (static)."""
    return _shift_axis(_shift_axis(img, dy, img.dim() - 2), dx, img.dim() - 1)


def warp_bilinear(img: torch.Tensor, flow_y: torch.Tensor,
                  flow_x: torch.Tensor) -> torch.Tensor:
    """Backward-warp (H, W) ``img`` by flow: out(x) = img(x + flow(x)).

    Bilinear with each tap's index clamped into the image, the semantics
    of ``map_coordinates(order=1, mode="nearest")``; not ``grid_sample``,
    whose coordinate rules differ. A gather: tests only.
    """
    h, w = img.shape
    yy = torch.arange(h, device=img.device).view(h, 1)
    xx = torch.arange(w, device=img.device).view(1, w)
    taps = []
    for coord, n in ((yy + flow_y, h), (xx + flow_x, w)):
        lower = torch.floor(coord)
        upper_w = coord - lower
        idx = lower.to(torch.int64)
        taps.append(((idx.clamp(0, n - 1), 1 - upper_w),
                     ((idx + 1).clamp(0, n - 1), upper_w)))
    out = None
    for iy, wy in taps[0]:
        for ix, wx in taps[1]:
            term = (wy * wx) * img[iy, ix]
            out = term if out is None else out + term
    return out


def _warp_axis_shifts(img: torch.Tensor, f: torch.Tensor, r: int,
                      axis_y: bool) -> torch.Tensor:
    """1-D linear resample along one axis via static shifts:
    sum_k max(0, 1 - |f - k|) * shift(img, k) for k in [-r, r]. ``f``
    must already be clamped to [-r, r]."""
    acc = torch.zeros_like(img)
    for k in range(-r, r + 1):
        wk = torch.clamp(1.0 - (f - k).abs(), min=0.0)
        acc = acc + wk * (shift_edge(img, k, 0) if axis_y
                          else shift_edge(img, 0, k))
    return acc


def warp_bilinear_shifts_plain(img: torch.Tensor, flow_y: torch.Tensor,
                               flow_x: torch.Tensor, r: int) -> torch.Tensor:
    """Plain twin of kernel B5: gather-free separable warp, flow clamped
    to [-r, r] per axis; vertical pass by ``flow_y``, then horizontal by
    ``flow_x`` (the horizontal pass reads the vertically warped plane,
    which was warped with ``flow_y`` at the column it is read from)."""
    fy = torch.clamp(flow_y, -r, r)
    fx = torch.clamp(flow_x, -r, r)
    return _warp_axis_shifts(_warp_axis_shifts(img, fy, r, True), fx, r,
                             False)


def _candidate_offsets(search: int, device) -> tuple:
    """(K, 1, 1) f32 dy and dx of the candidate grid, dy-major."""
    n = 2 * search + 1
    ax = torch.arange(-search, search + 1, device=device, dtype=torch.float32)
    return (ax.repeat_interleave(n).view(-1, 1, 1),
            ax.repeat(n).view(-1, 1, 1))


def flow_match_plain(cur: torch.Tensor, prev_w: torch.Tensor,
                     fy: torch.Tensor, fx: torch.Tensor, search: int = 2,
                     radius: int = 3, tau: float = 2.0) -> tuple:
    """Plain twin of kernel B6, the JAX package's XLA formulation: SAD of
    ``cur`` against each edge-replicated candidate shift of ``prev_w``
    over a border-clipped (2*radius+1)^2 box divided by the true window
    area, softmax over the candidates, the expected offset smoothed by an
    area-normalised radius-2 box and added to (fy, fx)."""
    h, w = cur.shape
    area = _area(h, w, radius, cur.device)
    costs = []
    for dy in range(-search, search + 1):
        for dx in range(-search, search + 1):
            cand = shift_edge(prev_w, dy, dx)
            costs.append(box_sum_2d((cur - cand).abs(), radius) / area)
    c = torch.stack(costs, dim=0)
    cmin = c.amin(dim=0, keepdim=True)
    wgt = torch.softmax(-(c - cmin) / tau, dim=0)
    dys, dxs = _candidate_offsets(search, cur.device)
    ry = (wgt * dys).sum(dim=0)
    rx = (wgt * dxs).sum(dim=0)
    sarea = _area(h, w, 2, cur.device)
    ry = box_sum_2d(ry, 2) / sarea
    rx = box_sum_2d(rx, 2) / sarea
    return fy + ry, fx + rx


def _resize_bl(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return resize2d(img, h, w, method="bilinear")


def _incoming(cur: torch.Tensor, fy, fx) -> tuple:
    """A level's incoming flow at ``cur``'s size: zero for None, else
    resized (bilinear) and scaled by the ratio of the sizes."""
    lh, lw = cur.shape
    if fy is None:
        fy = torch.zeros((lh, lw), dtype=torch.float32, device=cur.device)
        return fy, torch.zeros_like(fy)
    if tuple(fy.shape) == (lh, lw):
        return fy, fx
    sy, sx = lh / fy.shape[0], lw / fy.shape[1]
    return _resize_bl(fy, lh, lw) * sy, _resize_bl(fx, lh, lw) * sx


def _flow_level(cur: torch.Tensor, prev: torch.Tensor, fy: torch.Tensor,
                fx: torch.Tensor, search: int, radius: int,
                tau: float) -> tuple:
    """One refinement of the gather estimator: the unbounded gather warp,
    then the same match as :func:`flow_match_plain`."""
    prev_w = warp_bilinear(prev, fy, fx)
    return flow_match_plain(cur, prev_w, fy, fx, search, radius, tau)


def _flow_level_fast(cur: torch.Tensor, prev: torch.Tensor,
                     fy: torch.Tensor, fx: torch.Tensor, search: int,
                     radius: int, tau: float, warp_r: int) -> tuple:
    """One refinement level, gather-free: flow clamped to +-``warp_r``,
    warp (B5's twin), then match (B6's twin)."""
    fy = torch.clamp(fy, -warp_r, warp_r)
    fx = torch.clamp(fx, -warp_r, warp_r)
    prev_w = warp_bilinear_shifts_plain(prev, fy, fx, warp_r)
    return flow_match_plain(cur, prev_w, fy, fx, search, radius, tau)


def flow_level_plain(cur: torch.Tensor, prev: torch.Tensor, fy, fx,
                     search: int, radius: int, tau: float, r: int) -> tuple:
    """Plain twin of one level step of kernel B6: the incoming flow (None,
    or at the coarser level's or this level's size) resized and scaled to
    ``cur``'s size, clamped to +-``r``, the warp, then the match."""
    fy, fx = _incoming(cur, fy, fx)
    return _flow_level_fast(cur, prev, fy, fx, search, radius, tau, r)


def flow_level(cur: torch.Tensor, prev: torch.Tensor, fy, fx, search: int,
               radius: int, tau: float, r: int) -> tuple:
    """One level step: kernel B6 (upsample, clamp, warp and match in one
    launch) on a CUDA tensor, :func:`flow_level_plain` on a CPU tensor."""
    if not cur.is_cuda:
        return flow_level_plain(cur, prev, fy, fx, search, radius, tau, r)
    from video3d_tpu_torch.kernels import flowmatch

    return flowmatch.flow_level(cur, prev, fy, fx, search, radius, tau, r)


def _pyramid(cur: torch.Tensor, prev: torch.Tensor, levels: int) -> tuple:
    h, w = cur.shape[-2], cur.shape[-1]
    sizes = [(h, w)]
    for _ in range(levels - 1):
        ph, pw = sizes[-1]
        sizes.append((max(2, -(-ph // 2)), max(2, -(-pw // 2))))
    pyr = [(cur, prev)]
    if cur.is_cuda:
        # both guides through each resize at once: half the GEMM launches
        # (cuBLAS adds a split-K reduction to some of these shapes). The
        # CPU resizes them apart: a stacked matmul there rounds other ways
        # at small shapes, and the twins' results are pinned by test
        both = torch.stack([cur, prev])
        for ph, pw in sizes[1:]:
            both = _resize_bl(both, ph, pw)
            pyr.append((both[0], both[1]))
        return pyr
    for ph, pw in sizes[1:]:
        c, p = pyr[-1]
        pyr.append((_resize_bl(c, ph, pw), _resize_bl(p, ph, pw)))
    return pyr


def _coarse_to_fine(cur, prev, levels, step) -> tuple:
    """Shared pyramid walk of both estimators; ``step(lvl, c, p, fy, fx)``
    refines one level (twice at the coarsest) from the flow of the step
    before: None at first, then at the coarser level's size or its own."""
    pyr = _pyramid(cur, prev, levels)
    fy = fx = None
    for lvl in range(levels - 1, -1, -1):
        c, p = pyr[lvl]
        for _ in range(2 if lvl == levels - 1 else 1):
            fy, fx = step(lvl, c, p, fy, fx)
    return fy, fx


def estimate_flow_fast(cur: torch.Tensor, prev: torch.Tensor, max_flow: int,
                       levels: int = 3, search: int = 2, radius: int = 3,
                       tau: float = 2.0) -> tuple:
    """Gather-free coarse-to-fine backward flow cur -> prev for (H, W)
    gray in [0, 255]; each level's incoming flow is clamped to
    ceil(max_flow / 2^lvl) + search, so motion beyond +-max_flow
    saturates. Returns (flow_y, flow_x) f32 at the input resolution.
    One :func:`flow_level` per level step."""

    def step(lvl, c, p, fy, fx):
        r_lvl = -(-int(max_flow) // (2 ** lvl)) + search
        return flow_level(c, p, fy, fx, search, radius, tau, r_lvl)

    return _coarse_to_fine(cur, prev, levels, step)


def estimate_flow(cur: torch.Tensor, prev: torch.Tensor, levels: int = 3,
                  search: int = 2, radius: int = 3,
                  tau: float = 2.0) -> tuple:
    """Backward flow with the unbounded gather warp at every level (the
    JAX package's reference estimator). Tests only."""

    def step(lvl, c, p, fy, fx):
        fy, fx = _incoming(c, fy, fx)
        return _flow_level(c, p, fy, fx, search, radius, tau)

    return _coarse_to_fine(cur, prev, levels, step)


class FlowEMAParams(NamedTuple):
    """Flow-EMA smoothing knobs; a copy of the JAX package's
    ``FlowEMAParams`` (its docstring explains each), pinned equal by
    test. ``alpha_min``: current-frame weight at zero residual; ``gain``:
    photometric residual to alpha slope; ``max_warp``: full-resolution
    flow clamp in px/frame; ``d_gate_t0``/``d_gate_gain``: the
    full-resolution depth-residual gate (gain 0 disables it)."""

    alpha_min: float = 0.35
    gain: float = 0.08
    levels: int = 3
    search: int = 2
    max_warp: int = 16
    d_gate_t0: float = 1.0
    d_gate_gain: float = 1.0


def flow_ema_params_from_jax(d: dict) -> FlowEMAParams:
    """Port params from ``_asdict()`` of the JAX ``FlowEMAParams``."""
    unknown = set(d) - set(FlowEMAParams._fields)
    if unknown:
        raise ValueError(f"unknown FlowEMAParams fields: {sorted(unknown)}")
    return FlowEMAParams(**d)


def ema_tail_plain(p: FlowEMAParams, depth: torch.Tensor,
                   prev_out: torch.Tensor, g: torch.Tensor,
                   prev_g: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
                   rq: int) -> torch.Tensor:
    """Plain twin of kernel B5's EMA step: from the guide-scale flow to the
    (H, W) smoothed frame. The flow is clamped to +-``rq`` at guide scale
    (what the full-resolution warp can apply, so the photometric residual
    gates on the warp actually used), the residual of the warped previous
    guide sets alpha, and the previous smoothed depth, warped along the
    flow upsampled to full resolution, is blended with ``depth``; the
    depth-residual gate raises alpha where the warp disagrees."""
    hq, wq = g.shape
    h, w = depth.shape
    sy, sx = h / hq, w / wq
    fy = torch.clamp(fy, -rq, rq)
    fx = torch.clamp(fx, -rq, rq)
    prev_g_w = warp_bilinear_shifts_plain(prev_g, fy, fx, rq)
    resid = box_sum_2d((g - prev_g_w).abs(), 2) / _area(hq, wq, 2, g.device)
    alpha_q = torch.clamp(p.alpha_min + p.gain * resid, p.alpha_min, 1.0)

    fy_f = _resize_bl(fy, h, w) * sy
    fx_f = _resize_bl(fx, h, w) * sx
    alpha = _resize_bl(alpha_q, h, w)
    prev_warp = warp_bilinear_shifts_plain(prev_out, fy_f, fx_f, p.max_warp)
    if p.d_gate_gain > 0.0:
        rd = (box_sum_2d((depth - prev_warp).abs(), 2)
              / _area(h, w, 2, depth.device))
        a_d = torch.clamp((rd / (rd.mean() + 1e-6) - p.d_gate_t0)
                          * p.d_gate_gain, 0.0, 1.0)
        alpha = torch.maximum(alpha, a_d)
    return alpha * depth + (1.0 - alpha) * prev_warp


def ema_tail(p: FlowEMAParams, depth: torch.Tensor, prev_out: torch.Tensor,
             g: torch.Tensor, prev_g: torch.Tensor, fy: torch.Tensor,
             fx: torch.Tensor, rq: int, out: torch.Tensor = None):
    """The EMA step after the flow, written into ``out`` when given: kernel
    B5's EMA launches (two, three with the depth gate) on a CUDA tensor,
    :func:`ema_tail_plain` on a CPU tensor."""
    if depth.is_cuda:
        from video3d_tpu_torch.kernels import warp

        return warp.ema_tail(p, depth, prev_out, g, prev_g, fy, fx, rq, out)
    res = ema_tail_plain(p, depth, prev_out, g, prev_g, fy, fx, rq)
    return res if out is None else out.copy_(res)


def _ema_step(p: FlowEMAParams, carry: tuple, depth: torch.Tensor,
              g: torch.Tensor, out: torch.Tensor = None) -> tuple:
    """One frame: (prev smoothed depth, prev guide) carry, (H, W) depth
    and (hq, wq) guide in -> (new carry, (H, W) smoothed depth), the
    latter written into ``out`` when given."""
    prev_out, prev_g = carry
    hq, wq = g.shape
    h, w = depth.shape
    rq = max(1, int(round(p.max_warp / max(h / hq, w / wq))))
    fy, fx = estimate_flow_fast(g, prev_g, max_flow=rq, levels=p.levels,
                                search=p.search)
    res = ema_tail(p, depth, prev_out, g, prev_g, fy, fx, rq, out)
    return (res, g), res


def flow_ema_scan(carry, depth: torch.Tensor, guide: torch.Tensor,
                  params: FlowEMAParams = FlowEMAParams()) -> tuple:
    """Run the causal flow-EMA over a (T, H, W) depth batch with its
    (T, hq, wq) guide. ``carry`` is the previous call's (frame -1's
    smoothed depth, guide), or None to seed it from frame 0. Returns
    (new carry, (T, H, W) f32 smoothed); each frame is written in place
    into the result, and the carry stays on the device.
    """
    depth = depth.to(torch.float32).contiguous()
    guide = guide.to(torch.float32).contiguous()
    if carry is None:
        carry = (depth[0], guide[0])
    out = torch.empty_like(depth)
    for t in range(depth.shape[0]):
        carry, _ = _ema_step(params, carry, depth[t], guide[t], out[t])
    return carry, out
