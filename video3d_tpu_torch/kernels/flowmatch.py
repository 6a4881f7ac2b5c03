"""Kernel B6 wrapper: one pyramid level of the flow block matcher.

CUDA source: ``video3d_tpu_torch/csrc/flowmatch.cu`` (C entry
``v3d_flow_level``). Replaces the TPU kernel ``video3d_tpu/kernels/
flowmatch.py flow_match_pallas`` (body ``_match_kernel``). Two instances
of the one kernel:

* :func:`flow_level`, the flow smoother's level step: the incoming flow
  upsampled from the host's tap tables (``ops/image.py bilinear_taps``),
  scaled, clamped, the previous frame warped (B5's formula) and matched,
  in one launch; plain twin :func:`video3d_tpu_torch.ops.flow.
  flow_level_plain`, which :func:`video3d_tpu_torch.ops.flow.flow_level`
  runs for a CPU tensor;
* :func:`flow_match`, the public counterpart of ``flow_match_pallas``: the
  match of an already warped frame; plain twin
  :func:`video3d_tpu_torch.ops.flow.flow_match_plain`.

``launches`` counts every launch of either.
"""

from __future__ import annotations

import numpy as np
import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.ops.flow import flow_match_plain
from video3d_tpu_torch.ops.image import bilinear_taps_on

launches = 0  # launches of csrc/flowmatch.cu's kernel


def _launch(cur, prev, fy, fx, mode: int, r: int, search: int, radius: int,
            tau: float) -> tuple:
    global launches
    if search < 0 or radius < 0 or r < 0:
        raise ValueError("flow_level: search, radius and r must be >= 0")
    h, w = cur.shape
    oy = torch.empty_like(cur)
    ox = torch.empty_like(cur)
    taps = [None] * 4
    win, sy, sx = w, 1.0, 1.0
    if mode == 2:
        hin, win = fy.shape
        ty, tx = bilinear_taps_on(hin, h, cur.device), bilinear_taps_on(
            win, w, cur.device)
        taps = [t.data_ptr() for t in (*ty, *tx)]
        # the twin's python-float scale, rounded to f32 as torch's mul does
        sy, sx = float(np.float32(h / hin)), float(np.float32(w / win))
    # 1/tau rounded to f32 once, as the TPU kernel's jnp.float32(1.0 / tau)
    inv_tau = float(np.float32(1.0 / tau))
    _build.check(_build.lib().v3d_flow_level(
        cur.data_ptr(), prev.data_ptr(),
        None if fy is None else fy.data_ptr(),
        None if fx is None else fx.data_ptr(), oy.data_ptr(), ox.data_ptr(),
        h, w, win, *taps, sy, sx, mode, int(r), int(search), int(radius),
        inv_tau, _build.stream_of(cur)), "v3d_flow_level")
    launches += 1
    return oy, ox


def flow_level(cur: torch.Tensor, prev: torch.Tensor, fy, fx, search: int,
               radius: int, tau: float, r: int) -> tuple:
    """One level step on the card: (h, w) f32 ``cur`` and un-warped
    ``prev``; the incoming flow (fy, fx) at the coarser level's size or at
    (h, w), or None for zero. Returns the refined (fy, fx) at (h, w)."""
    _build.require(cur, torch.float32, 2, "flow_level cur")
    _build.require(prev, torch.float32, 2, "flow_level prev")
    if prev.shape != cur.shape:
        raise ValueError("flow_level: cur and prev shapes differ")
    if fy is None:
        return _launch(cur, prev, None, None, 1, r, search, radius, tau)
    _build.require(fy, torch.float32, 2, "flow_level fy")
    _build.require(fx, torch.float32, 2, "flow_level fx")
    if fx.shape != fy.shape:
        raise ValueError("flow_level: fy and fx shapes differ")
    return _launch(cur, prev, fy, fx, 2, r, search, radius, tau)


def flow_match(cur: torch.Tensor, prev_w: torch.Tensor, fy: torch.Tensor,
               fx: torch.Tensor, search: int = 2, radius: int = 3,
               tau: float = 2.0) -> tuple:
    """(h, w) f32 ``cur`` against ``prev_w`` (the previous frame already
    warped by (fy, fx)) -> (fy, fx) + smoothed softargmin residual.

    A CUDA tensor runs the kernel, a CPU tensor the plain twin.
    """
    if not cur.is_cuda:
        return flow_match_plain(cur, prev_w, fy, fx, search, radius, tau)
    cur, prev_w = cur.contiguous(), prev_w.contiguous()
    fy, fx = fy.contiguous(), fx.contiguous()
    for t, name in ((cur, "flow_match cur"), (prev_w, "flow_match prev_w"),
                    (fy, "flow_match fy"), (fx, "flow_match fx")):
        _build.require(t, torch.float32, 2, name)
        if t.shape != cur.shape:
            raise ValueError("flow_match: input shapes differ")
    return _launch(cur, prev_w, fy, fx, 0, 0, search, radius, tau)
