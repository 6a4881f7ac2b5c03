"""Disparity hole filling: background extension along scan lines.

Counterpart of :mod:`video3d_tpu.ops.fill`. Each hole pixel takes the
smaller of the nearest valid disparities to its left and to its right:
occluded regions belong to the background, which has the smaller
disparity. The JAX package propagates by log-step doubling (a TPU choice);
here the nearest valid index comes from a running max (min from the right)
of valid column indices and one gather, with the same result.
"""

from __future__ import annotations

import torch


def fill_holes(disp: torch.Tensor, invalid: float) -> torch.Tensor:
    """Fill ``disp == invalid`` pixels with min(nearest valid left,
    nearest valid right) along each row; holes with no valid pixel on
    either side (blank rows) stay at ``invalid``.

    disp: (..., W) float; returns the same shape and dtype.
    """
    w = disp.shape[-1]
    valid = disp != invalid
    cols = torch.arange(w, device=disp.device).expand(disp.shape)
    # nearest valid column at or left of x (-1: none), and at or right of
    # x (w: none)
    left = torch.where(valid, cols, -1).cummax(dim=-1).values
    right = torch.where(valid, cols, w).flip(-1).cummin(dim=-1).values.flip(-1)
    # python scalars, not host tensors: copying one to the card would wait
    # for the matcher's kernels before the guidance could be launched
    inf = float("inf")
    lv = torch.where(left >= 0, disp.gather(-1, left.clamp(min=0)), inf)
    rv = torch.where(right < w, disp.gather(-1, right.clamp(max=w - 1)), inf)
    fill = torch.minimum(lv, rv)
    fill = torch.where(torch.isinf(fill), float(invalid), fill)
    return torch.where(valid, disp, fill)
