"""Kernel B2 and B3 wrappers: SGM sweeps and winner-take-all.

CUDA source: ``video3d_tpu_torch/csrc/sgm.cu``. B2 replaces the TPU kernel
``video3d_tpu/kernels/sgm.py _directional_pass_dmajor`` (the forward and
backward horizontal sweeps); B3 replaces ``sgm_wta_pallas_dmajor`` (the
top-down vertical and diagonal sweeps plus WTA). Volumes are in the port's
``(B, H, W, D)`` int16 layout; the plain twins are
:func:`video3d_tpu_torch.ops.stereo.sgm_sweep_dmajor` and
:func:`~video3d_tpu_torch.ops.stereo.sgm_down_wta_dmajor` on permuted views.
"""

from __future__ import annotations

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.ops.stereo import (SGBMParams, acc_dtype_for_params,
                                          integral_penalties,
                                          sgm_down_wta_dmajor,
                                          sgm_sweep_dmajor)

sweep_launches = 0  # B2: calls that launched the CUDA sweeps
wta_launches = 0  # B3: calls that launched the CUDA sweeps + WTA


def horizontal_sweeps_plain(cost: torch.Tensor,
                            params: SGBMParams) -> torch.Tensor:
    """Plain B2: left-to-right plus right-to-left path sums, (B, H, W, D)."""
    acc_dtype = acc_dtype_for_params(cost.dtype, params)
    cost_t = cost.permute(0, 2, 3, 1).contiguous()  # (B, W, D, H)
    acc_t = sgm_sweep_dmajor(cost_t, None, (0,), params.p1, params.p2,
                             False, acc_dtype)
    acc_t = sgm_sweep_dmajor(cost_t, acc_t, (0,), params.p1, params.p2, True)
    return acc_t.permute(0, 3, 1, 2).contiguous()


def down_sweeps_wta_plain(cost: torch.Tensor, acc: torch.Tensor,
                          params: SGBMParams, return_margin: bool = False):
    """Plain B3: downward sweeps added to ``acc``, then WTA -> (B, H, W)."""
    return sgm_down_wta_dmajor(cost.permute(0, 1, 3, 2),
                               acc.permute(0, 1, 3, 2), params,
                               return_margin=return_margin)


def _check_volume(cost: torch.Tensor, params: SGBMParams) -> None:
    _build.require(cost, torch.int16, 4, "sgm cost")
    if cost.shape[-1] != params.num_disparities or cost.shape[-1] > 128:
        raise ValueError("sgm: last axis must be num_disparities <= 128")
    if acc_dtype_for_params(cost.dtype, params) != torch.int16:
        raise ValueError("sgm: path totals overflow the int16 accumulator")


def _sweep(lib, cost, acc_in, acc_out, dy, dx, p1, p2, stream) -> None:
    b, h, w, d = cost.shape
    _build.check(lib.v3d_sgm_sweep(
        cost.data_ptr(), None if acc_in is None else acc_in.data_ptr(),
        acc_out.data_ptr(), b, h, w, d, dy, dx, p1, p2, stream),
        "v3d_sgm_sweep")


def horizontal_sweeps(cost: torch.Tensor, params: SGBMParams) -> torch.Tensor:
    """B2: (B, H, W, D) int16 cost -> int16 sum of both horizontal paths."""
    global sweep_launches
    if not cost.is_cuda:
        return horizontal_sweeps_plain(cost, params)
    _check_volume(cost, params)
    p1, p2 = integral_penalties(params.p1, params.p2)
    lib = _build.lib()
    stream = _build.stream_of(cost)
    acc = torch.empty_like(cost)
    _sweep(lib, cost, None, acc, 0, 1, p1, p2, stream)
    _sweep(lib, cost, acc, acc, 0, -1, p1, p2, stream)
    sweep_launches += 1
    return acc


def down_sweeps_wta(cost: torch.Tensor, acc: torch.Tensor,
                    params: SGBMParams, return_margin: bool = False):
    """B3: adds the vertical and both diagonal top-down paths to ``acc``
    (in place on the card) and returns the validated disparity (B, H, W)
    f32, plus the uniqueness margin with ``return_margin``."""
    global wta_launches
    if not cost.is_cuda:
        return down_sweeps_wta_plain(cost, acc, params, return_margin)
    _check_volume(cost, params)
    _build.require(acc, torch.int16, 4, "sgm acc")
    if acc.shape != cost.shape:
        raise ValueError("sgm: acc and cost shapes differ")
    p1, p2 = integral_penalties(params.p1, params.p2)
    lib = _build.lib()
    stream = _build.stream_of(cost)
    for dx in (0, 1, -1):
        _sweep(lib, cost, acc, acc, 1, dx, p1, p2, stream)
    b, h, w, d = cost.shape
    disp = torch.empty((b, h, w), dtype=torch.float32, device=cost.device)
    margin = torch.empty_like(disp) if return_margin else None
    _build.check(lib.v3d_sgm_wta(
        acc.data_ptr(), disp.data_ptr(),
        None if margin is None else margin.data_ptr(), b, h, w, d,
        int(params.min_disparity), int(params.uniqueness_ratio),
        int(params.disp12_max_diff), stream), "v3d_sgm_wta")
    wta_launches += 1
    return (disp, margin) if return_margin else disp
