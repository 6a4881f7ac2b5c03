"""Kernel B5 wrapper: gather-free separable shift warp (flow smoother).

CUDA source: ``video3d_tpu_torch/csrc/warp.cu``. Replaces the TPU kernel
``video3d_tpu/kernels/warp.py warp_bilinear_shifts_pallas`` (bodies
``_vwarp_kernel`` and ``_hwarp_kernel``); the plain twin is
:func:`video3d_tpu_torch.ops.flow.warp_bilinear_shifts_plain`.
"""

from __future__ import annotations

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.ops.flow import warp_bilinear_shifts_plain

launches = 0  # calls that launched the CUDA kernel


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
