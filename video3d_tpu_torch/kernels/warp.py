"""Kernel B5 wrapper: the separable shift warp and the flow smoother's
full-resolution EMA step built around it.

CUDA source: ``video3d_tpu_torch/csrc/warp.cu`` (C entries ``v3d_warp``,
``v3d_ema_guide``, ``v3d_ema_step``). Replaces the TPU kernel
``video3d_tpu/kernels/warp.py warp_bilinear_shifts_pallas`` (bodies
``_vwarp_kernel`` and ``_hwarp_kernel``). Instances of the one kernel:

* :func:`warp_bilinear_shifts`, the public counterpart of the TPU kernel;
  plain twin :func:`video3d_tpu_torch.ops.flow.warp_bilinear_shifts_plain`;
* :func:`ema_tail`, the EMA step after the flow: the guide-scale alpha
  (one launch), then the warp of the previous smoothed depth along the
  flow upsampled from the host's tap tables, the depth gate's mean (one
  launch, with the gate on) and the blend into the caller's frame (one
  launch); plain twin :func:`video3d_tpu_torch.ops.flow.ema_tail_plain`,
  which :func:`video3d_tpu_torch.ops.flow.ema_tail` runs for a CPU tensor.

``launches`` counts every launch of the source.
"""

from __future__ import annotations

import numpy as np
import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.ops.flow import warp_bilinear_shifts_plain
from video3d_tpu_torch.ops.image import bilinear_taps_on

launches = 0  # launches of csrc/warp.cu's kernel

# per device: a ticket word (0 between calls), the mean and the head's
# per-block sums; the calls on a device run in the order of its stream
_scratch = {}


def _f32(x: float) -> float:
    return float(np.float32(x))


def warp_bilinear_shifts(img: torch.Tensor, flow_y: torch.Tensor,
                         flow_x: torch.Tensor, r: int) -> torch.Tensor:
    """(H, W) f32 image warped by (flow_y, flow_x) clamped to [-r, r].

    A CUDA tensor runs the kernel, a CPU tensor the plain twin.
    """
    global launches
    if not img.is_cuda:
        return warp_bilinear_shifts_plain(img, flow_y, flow_x, r)
    img, fy, fx = img.contiguous(), flow_y.contiguous(), flow_x.contiguous()
    for t, name in ((img, "warp img"), (fy, "warp flow_y"),
                    (fx, "warp flow_x")):
        _build.require(t, torch.float32, 2, name)
    if fy.shape != img.shape or fx.shape != img.shape:
        raise ValueError("warp: image and flow shapes differ")
    h, w = img.shape
    out = torch.empty_like(img)
    _build.check(_build.lib().v3d_warp(
        img.data_ptr(), fy.data_ptr(), fx.data_ptr(), out.data_ptr(), h, w,
        int(r), _build.stream_of(img)), "v3d_warp")
    launches += 1
    return out


def _scratch_for(device: torch.device, blocks: int) -> torch.Tensor:
    buf = _scratch.get(device)
    if buf is None or buf.numel() < 2 + blocks:
        buf = torch.zeros(2 + blocks, dtype=torch.float32, device=device)
        _scratch[device] = buf
    return buf


def ema_tail(p, depth: torch.Tensor, prev_out: torch.Tensor, g: torch.Tensor,
             prev_g: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
             rq: int, out: torch.Tensor = None) -> torch.Tensor:
    """The EMA step on the card: (H, W) f32 ``depth`` and ``prev_out``,
    (hq, wq) f32 guides ``g``, ``prev_g`` and guide-scale flow (fy, fx);
    ``p`` a ``FlowEMAParams``. Writes the smoothed frame into ``out`` (a
    new tensor when None) and returns it."""
    global launches
    for t, name in ((depth, "ema depth"), (prev_out, "ema prev_out"),
                    (g, "ema g"), (prev_g, "ema prev_g"), (fy, "ema fy"),
                    (fx, "ema fx")):
        _build.require(t, torch.float32, 2, name)
    h, w = depth.shape
    hq, wq = g.shape
    if prev_out.shape != depth.shape or any(
            t.shape != g.shape for t in (prev_g, fy, fx)):
        raise ValueError("ema_tail: shapes differ")
    if out is None:
        out = torch.empty_like(depth)
    _build.require(out, torch.float32, 2, "ema out")
    if out.shape != depth.shape:
        raise ValueError("ema_tail: out shape differs")
    lib, stream = _build.lib(), _build.stream_of(depth)
    alpha_q = torch.empty_like(g)
    _build.check(lib.v3d_ema_guide(
        g.data_ptr(), prev_g.data_ptr(), fy.data_ptr(), fx.data_ptr(),
        alpha_q.data_ptr(), hq, wq, int(rq), _f32(p.alpha_min), _f32(p.gain),
        stream), "v3d_ema_guide")
    launches += 1
    gate = p.d_gate_gain > 0.0
    scratch = _scratch_for(depth.device, lib.v3d_ema_blocks(h, w)) if gate \
        else None
    ty, tx = bilinear_taps_on(hq, h, depth.device), bilinear_taps_on(
        wq, w, depth.device)
    _build.check(lib.v3d_ema_step(
        depth.data_ptr(), prev_out.data_ptr(), fy.data_ptr(), fx.data_ptr(),
        alpha_q.data_ptr(), out.data_ptr(), h, w, hq, wq,
        *(t.data_ptr() for t in (*ty, *tx)), _f32(h / hq), _f32(w / wq),
        int(rq), int(p.max_warp), int(gate), _f32(p.d_gate_t0),
        _f32(p.d_gate_gain), None if scratch is None else scratch.data_ptr(),
        stream), "v3d_ema_step")
    launches += 2 if gate else 1
    return out
