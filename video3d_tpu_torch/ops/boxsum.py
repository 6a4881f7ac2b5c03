"""Border-clipped windowed box sums via cumulative sums.

Counterpart of :mod:`video3d_tpu.ops.boxsum`: the window [i-r, i+r] is
clipped at the borders (no zero padding counted), computed as the
difference of two shifted cumulative sums, O(1) per element.
"""

from __future__ import annotations

import torch


def box_sum_axis(x: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    """Sum over a clipped window [i-r, i+r] along ``axis``."""
    n = x.shape[axis]
    r = min(r, n - 1)  # window clips at the borders; r >= n-1 spans all
    if r <= 0:
        return x
    c = torch.cumsum(x, dim=axis)
    last = c.narrow(axis, n - 1, 1)
    hi = torch.cat(
        [c.narrow(axis, r, n - r), last.expand_as(c.narrow(axis, 0, r))],
        dim=axis,
    )
    zeros = torch.zeros_like(c.narrow(axis, 0, r + 1))
    lo = torch.cat([zeros, c.narrow(axis, 0, n - r - 1)], dim=axis)
    return hi - lo


def box_sum_2d(x: torch.Tensor, r: int) -> torch.Tensor:
    """Windowed sum over (2r+1)^2 neighbourhoods of the last two axes."""
    return box_sum_axis(box_sum_axis(x, -2, r), -1, r)


def window_area(h: int, w: int, r: int, device=None) -> torch.Tensor:
    """True (border-clipped) window area per pixel, (h, w) float32."""
    return box_sum_2d(torch.ones((h, w), device=device), r)
