"""Banded-vote speckle filter, plain PyTorch.

Counterpart of :func:`video3d_tpu.ops.speckle.speckle_filter_device` and
the plain twin of the CUDA kernel :mod:`video3d_tpu_torch.kernels.speckle`.
Disparities are quantised into bands of width ``max_diff``; a valid pixel
survives if at least ``min_region`` valid pixels of its own or an adjacent
band lie in its border-clipped (2r+1)^2 window, r = max(2, ceil(sqrt(
min_region))). Counts are exact small integers, so kernel and twin agree
bit for bit.
"""

from __future__ import annotations

import math

import torch

from video3d_tpu_torch.ops.boxsum import box_sum_2d


def speckle_geometry(max_diff: float, min_region: int,
                     value_range: tuple) -> tuple:
    """(radius, n_bands, lo) of the banded vote."""
    radius = max(2, int(math.ceil(math.sqrt(float(min_region)))))
    lo_v, hi_v = float(value_range[0]), float(value_range[1])
    n_bands = max(1, int(math.ceil((hi_v - lo_v) / float(max_diff)))) + 1
    return radius, n_bands, lo_v


def speckle_filter_device(
    disp: torch.Tensor,
    invalid: float,
    max_diff: float,
    min_region: int,
    value_range: tuple = (0.0, 64.0),
) -> torch.Tensor:
    """Approximate speckle removal, (..., H, W) float32 -> same shape."""
    if min_region <= 0:
        return disp
    radius, n_bands, lo_v = speckle_geometry(max_diff, min_region,
                                             value_range)
    valid = disp != invalid
    band = torch.clamp(
        torch.floor((disp - lo_v) / float(max_diff)).to(torch.int32),
        0, n_bands - 1,
    )
    counts = [
        box_sum_2d(((band == k) & valid).to(torch.float32), radius)
        for k in range(n_bands)
    ]
    support = torch.zeros_like(disp, dtype=torch.float32)
    for k in range(n_bands):
        s_k = counts[k]
        if k > 0:
            s_k = s_k + counts[k - 1]
        if k < n_bands - 1:
            s_k = s_k + counts[k + 1]
        support = torch.where(band == k, s_k, support)
    keep = valid & (support >= float(min_region))
    return torch.where(keep, disp, torch.full_like(disp, float(invalid)))
