"""Kernel B6 wrapper: one pyramid level of the flow block matcher.

CUDA source: ``video3d_tpu_torch/csrc/flowmatch.cu``. Replaces the TPU
kernel ``video3d_tpu/kernels/flowmatch.py flow_match_pallas`` (body
``_match_kernel``); the plain twin is
:func:`video3d_tpu_torch.ops.flow.flow_match_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.ops.flow import flow_match_plain

launches = 0  # calls that launched the CUDA kernel


def flow_match(cur: torch.Tensor, prev_w: torch.Tensor, fy: torch.Tensor,
               fx: torch.Tensor, search: int = 2, radius: int = 3,
               tau: float = 2.0) -> tuple:
    """(h, w) f32 ``cur`` against ``prev_w`` (the previous frame already
    warped by (fy, fx)) -> (fy, fx) + smoothed softargmin residual.

    A CUDA tensor runs the kernel, a CPU tensor the plain twin.
    """
    global launches
    if not cur.is_cuda:
        return flow_match_plain(cur, prev_w, fy, fx, search, radius, tau)
    cur, prev_w = cur.contiguous(), prev_w.contiguous()
    fy, fx = fy.contiguous(), fx.contiguous()
    for t, name in ((cur, "flow_match cur"), (prev_w, "flow_match prev_w"),
                    (fy, "flow_match fy"), (fx, "flow_match fx")):
        _build.require(t, torch.float32, 2, name)
        if t.shape != cur.shape:
            raise ValueError("flow_match: input shapes differ")
    if search < 0 or radius < 0:
        raise ValueError("flow_match: search and radius must be >= 0")
    h, w = cur.shape
    oy = torch.empty_like(cur)
    ox = torch.empty_like(cur)
    # 1/tau rounded to f32 once, as the TPU kernel's jnp.float32(1.0 / tau)
    inv_tau = float(np.float32(1.0 / tau))
    _build.check(_build.lib().v3d_flow_match(
        cur.data_ptr(), prev_w.data_ptr(), fy.data_ptr(), fx.data_ptr(),
        oy.data_ptr(), ox.data_ptr(), h, w, int(search), int(radius),
        inv_tau, _build.stream_of(cur)), "v3d_flow_match")
    launches += 1
    return oy, ox
