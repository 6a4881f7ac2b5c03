"""Kernel B1 wrapper: prefiltered BT cost volume with a 5x5 box sum.

CUDA source: ``video3d_tpu_torch/csrc/costvol.cu``. Replaces the TPU
kernel ``video3d_tpu/kernels/costvol.py fused_cost_volume``. The output is
the port's internal ``(B, H, W, D)`` int16 layout; the plain twin is
:func:`video3d_tpu_torch.ops.stereo.cost_volume_dmajor` (JAX D-major
layout), permuted.
"""

from __future__ import annotations

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.ops.stereo import SGBMParams, cost_volume_dmajor

launches = 0  # calls that launched the CUDA kernel


def cost_volume_plain(left_gray: torch.Tensor, right_gray: torch.Tensor,
                      params: SGBMParams, raw_invalid: float,
                      return_filtered_left: bool = False):
    """Plain PyTorch B1 in the kernel's (B, H, W, D) layout."""
    res = cost_volume_dmajor(left_gray, right_gray, params, raw_invalid,
                             return_filtered_left)
    cost, lf = res if return_filtered_left else (res, None)
    cost = cost.permute(0, 1, 3, 2).contiguous()
    return (cost, lf) if return_filtered_left else cost


def cost_volume(left_gray: torch.Tensor, right_gray: torch.Tensor,
                params: SGBMParams, raw_invalid: float,
                return_filtered_left: bool = False):
    """(B, H, W) f32 raw gray pair -> (B, H, W, D) int16 cost volume
    (and the int16 prefiltered left view with ``return_filtered_left``).

    A CUDA tensor runs the kernel, a CPU tensor the plain twin.
    """
    global launches
    if not left_gray.is_cuda:
        return cost_volume_plain(left_gray, right_gray, params, raw_invalid,
                                 return_filtered_left)
    _build.require(left_gray, torch.float32, 3, "cost_volume left")
    _build.require(right_gray, torch.float32, 3, "cost_volume right")
    if right_gray.shape != left_gray.shape:
        raise ValueError("cost_volume: eye shapes differ")
    inv2 = 2.0 * float(raw_invalid)
    cap = int(params.prefilter_cap)
    if inv2 != int(inv2) or inv2 < 0:
        raise ValueError(f"raw_invalid must be a multiple of 0.5: {raw_invalid}")
    if params.block_size**2 * max(inv2, 4 * cap) / 2 >= 2**15 or params.block_size % 2 != 1:
        raise ValueError("cost_volume: box total overflows int16 or even block")
    if not 0 < params.num_disparities <= 128:
        raise ValueError("cost_volume: num_disparities must be in [1, 128]")
    b, h, w = left_gray.shape
    d = params.num_disparities
    dev = left_gray.device
    lib = _build.lib()
    stream = _build.stream_of(left_gray)
    lf = torch.empty((b, h, w), dtype=torch.int16, device=dev)
    rf = torch.empty((b, h, w), dtype=torch.int16, device=dev)
    out = torch.empty((b, h, w, d), dtype=torch.int16, device=dev)
    _build.check(lib.v3d_prefilter(left_gray.data_ptr(), right_gray.data_ptr(),
                                   lf.data_ptr(), rf.data_ptr(), b, h, w,
                                   float(cap), stream), "v3d_prefilter")
    _build.check(lib.v3d_cost_volume(lf.data_ptr(), rf.data_ptr(),
                                     out.data_ptr(), b, h, w, d,
                                     int(params.min_disparity),
                                     int(params.block_size), int(inv2),
                                     stream), "v3d_cost_volume")
    launches += 1
    return (out, lf) if return_filtered_left else out
