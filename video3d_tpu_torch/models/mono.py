"""Scale-and-shift alignment of monocular depth (from
:mod:`video3d_tpu.models.mono`).

Only :func:`ssi_align` is ported: the depth stage uses it to land a
monocular guide in disparity units. The rest of the JAX module (the
MonoDepthLite network, its losses and checkpoint) is still to port.
"""

from __future__ import annotations

from typing import Tuple

import torch


def ssi_align(pred: torch.Tensor, target: torch.Tensor,
              valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image least-squares (s, t) aligning ``pred`` to ``target`` on
    the pixels weighted by ``valid``; (B, H, W) in, (B, 1, 1) each out.

    Monocular depth is defined up to an affine map, so it is aligned per
    image onto the weighted stereo disparities. A degenerate fit
    (|det| <= 1e-6) gives s = 1.
    """
    v = valid
    dims = (-2, -1)
    n = torch.clamp(v.sum(dim=dims), min=1.0)
    sp = (pred * v).sum(dim=dims)
    st = (target * v).sum(dim=dims)
    spp = (pred * pred * v).sum(dim=dims)
    spt = (pred * target * v).sum(dim=dims)
    det = n * spp - sp * sp
    s = torch.where(det.abs() > 1e-6, (n * spt - sp * st) / det, 1.0)
    t = (st - s * sp) / n
    return s[:, None, None], t[:, None, None]
