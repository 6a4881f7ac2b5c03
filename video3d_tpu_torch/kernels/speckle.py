"""Kernel B4 wrapper: banded-window speckle vote.

CUDA source: ``video3d_tpu_torch/csrc/speckle.cu``: one kernel that walks
strips of columns down the rows and counts the window with running sums
(packed cumulative band planes for up to four bands, a per-column band
histogram above that). Replaces the TPU kernel ``video3d_tpu/kernels/speckle.py speckle_filter_pallas``; the plain
twin is :func:`video3d_tpu_torch.ops.speckle.speckle_filter_device`.
"""

from __future__ import annotations

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.ops.speckle import (speckle_filter_device,
                                           speckle_geometry)

launches = 0  # calls that launched the CUDA kernel


def speckle_filter(disp: torch.Tensor, invalid: float, max_diff: float,
                   min_region: int,
                   value_range: tuple = (0.0, 64.0)) -> torch.Tensor:
    """(B, H, W) f32 disparity -> same, small blobs set to ``invalid``.

    A CUDA tensor runs the kernel, a CPU tensor the plain twin.
    """
    global launches
    if not disp.is_cuda:
        return speckle_filter_device(disp, invalid, max_diff, min_region,
                                     value_range)
    if min_region <= 0:
        return disp
    _build.require(disp, torch.float32, 3, "speckle disp")
    radius, n_bands, lo_v = speckle_geometry(max_diff, min_region,
                                             value_range)
    b, h, w = disp.shape
    out = torch.empty_like(disp)
    lib = _build.lib()
    _build.check(lib.v3d_speckle(
        disp.data_ptr(), out.data_ptr(), b, h, w,
        float(invalid), float(max_diff), lo_v, n_bands, radius,
        int(min_region), _build.stream_of(disp)), "v3d_speckle")
    launches += 1
    return out
