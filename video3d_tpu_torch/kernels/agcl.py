"""Kernel A1 wrapper: one call of the published CREStereo's adaptive group
correlation (AGCL), the warped route (1/4) or the deformable one (1/16 and
1/8), the 1x9 row or the 3x3 window.

CUDA source: ``video3d_tpu_torch/csrc/agcl.cu`` (C entry ``v3d_agcl``). It
replaces no TPU kernel: the JAX package has no published CREStereo. The
plain twin is the model's own code,
:func:`video3d_tpu_torch.models.crestereo_net.agcl_warped` and
:func:`~video3d_tpu_torch.models.crestereo_net.agcl_deformable`:
:func:`correlate` sends a CPU tensor there and a CUDA tensor to A1 (one
launch a call), or raises.

A1 reads the feature maps and the offsets channels-last (a pixel's
channels in one piece) and writes the correlation channels-last;
:func:`kernel_layout` puts a CUDA map there, once a cascade level.

``launches`` counts every launch of the source.
"""

from __future__ import annotations

from typing import Optional

import torch

from video3d_tpu_torch.kernels import _build

launches = 0  # launches of csrc/agcl.cu's kernels

GROUP_CHANNELS = 64  # channels of a group, the kernel's
POINTS = 9  # search points of a pattern
CL = torch.channels_last


def kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """A CUDA map or offset (B, C, h, w) as A1 reads it: f32,
    channels-last (no copy where it is already); a CPU tensor as it is,
    for the twin."""
    if not t.is_cuda:
        return t
    return t.to(torch.float32).contiguous(memory_format=CL)


def _check_map(t: torch.Tensor, shape: tuple, device, name: str) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"agcl {name}: expected a tensor on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"agcl {name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"agcl {name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous(memory_format=CL) or t.data_ptr() % 16:
        raise ValueError(f"agcl {name}: expected a channels-last tensor "
                         f"16-byte aligned (kernel_layout)")


def correlate(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
              offset: Optional[torch.Tensor], small: bool, groups: int,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The AGCL of ``f1`` against ``f2`` (B, C, h, w) at ``flow`` (B, 2,
    h, w), f32: with ``offset`` (B, 18, h, w) the deformable route, else
    the warped one; ``small`` the 3x3 window, else the 1x9 row; (B,
    groups * 9, h, w), group-major.

    A CUDA tensor runs A1 (the maps and offset in :func:`kernel_layout`,
    C = 64 x ``groups``, the flow at any strides) and returns
    channels-last f32, into ``out`` where given; a CPU tensor runs the
    plain twin.
    """
    global launches
    if not f1.is_cuda:
        from video3d_tpu_torch.models.crestereo_net import (agcl_deformable,
                                                            agcl_warped)
        if offset is None:
            return agcl_warped(f1, f2, flow, small, groups)
        return agcl_deformable(f1, f2, flow, offset, small, groups)
    b, c, h, w = f1.shape
    if c != GROUP_CHANNELS * groups:
        raise ValueError(f"agcl: {c} channels are not {groups} groups of "
                         f"{GROUP_CHANNELS}")
    dev = f1.device
    _check_map(f1, (b, c, h, w), dev, "f1")
    _check_map(f2, (b, c, h, w), dev, "f2")
    if offset is not None:
        _check_map(offset, (b, 2 * POINTS, h, w), dev, "offset")
    if flow.device != dev or flow.dtype != torch.float32 \
            or tuple(flow.shape) != (b, 2, h, w):
        raise ValueError(f"agcl flow: expected ({b}, 2, {h}, {w}) float32 "
                         f"on {dev}")
    if out is None:
        out = torch.empty((b, h, w, groups * POINTS), dtype=torch.float32,
                          device=dev).permute(0, 3, 1, 2)
    else:
        _check_map(out, (b, groups * POINTS, h, w), dev, "out")
    _build.check(_build.lib().v3d_agcl(
        f1.data_ptr(), f2.data_ptr(), flow.data_ptr(),
        None if offset is None else offset.data_ptr(), out.data_ptr(), b, h,
        w, groups, int(bool(small)), *flow.stride(), _build.stream_of(f1)),
        "v3d_agcl")
    launches += 1
    return out
