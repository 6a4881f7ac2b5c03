"""Kernel B2, B3 and B8a wrappers: SGM sweeps and winner-take-all.

CUDA source: ``video3d_tpu_torch/csrc/sgm.cu``: one horizontal kernel that
runs a row's two directions from its two ends in a single launch (B2), and
one vertical kernel that runs every direction of one sweep step ``dy`` in
a single launch and, in the launch that closes the mode, the WTA on the
total it holds in registers (B3), with a small LR-check kernel after it.
B8a is the same two kernels on an f32 or bf16 cost: the horizontal pair in
one launch, then one vertical launch per sweep step that stores the f32
total (1, 2 or 3 launches at 2, 5 or 4 and 8 paths). B2 replaces the TPU
kernel ``video3d_tpu/kernels/sgm.py _directional_pass_dmajor`` (the
forward and backward horizontal sweeps, int16 or f32 accumulator); B3
replaces ``sgm_wta_pallas_dmajor`` (the vertical sweeps of the mode --
top-down for 5 paths, top-down then bottom-up for 4 and 8 -- plus WTA);
B8a replaces ``_directional_pass``, the sweeps of ``sgm_aggregate_pallas``
on an f32 or bf16 cost. B3's arithmetic is picked by
:func:`vertical_route`: an int16 5-path mode whose values fit runs on
packed 16-bit pairs (Hopper's DPX instructions), every other integer mode
in int32, a float cost (B8a) in f32. Volumes are in the port's
``(B, H, W, D)`` layout; the plain twins are
:func:`video3d_tpu_torch.ops.stereo.sgm_sweep_dmajor`,
:func:`~video3d_tpu_torch.ops.stereo.sgm_vertical_wta_dmajor` and
:func:`~video3d_tpu_torch.ops.stereo.sgm_aggregate` on permuted views.
"""

from __future__ import annotations

import ctypes

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.ops.stereo import (SGBMParams, acc_dtype_for_params,
                                          check_integer_totals,
                                          integral_penalties, path_bound,
                                          sgm_aggregate, sgm_sweep_dmajor,
                                          sgm_vertical_wta_dmajor,
                                          vertical_directions,
                                          vertical_shifts)

sweep_launches = 0  # B2: calls that launched the CUDA horizontal sweeps
wta_launches = 0  # B3: calls that launched the CUDA vertical sweeps + WTA
vertical_packed_launches = 0  # B3 calls of those on the packed route
aggregate_launches = 0  # B8a: calls that launched the CUDA float sweeps
# the last 3-direction vertical launch (B3's or B8a's): (blocks per
# multiprocessor, multiprocessors, strips per frame, frames per chunk,
# chunks, columns per block), or None
vertical_plan = None
# the last horizontal launch (B2's or B8a's): (blocks per multiprocessor,
# multiprocessors, blocks launched, rounds of row groups a warp takes), or
# None
horizontal_plan = None
# B8a's last call: (device kernels it launched, vertical sweep steps), or
# None
aggregate_plan = None

# dtype codes of the C interface
_CODE = {torch.int16: 0, torch.float32: 1, torch.bfloat16: 2}
# the packed route's sentinel past both ends of d (csrc/sgm_common.cuh
# SENT16): every value of the route lies in [0, 2^15)
PACKED_SENT = 1 << 14


def vertical_route(cost_dtype: torch.dtype, params: SGBMParams) -> str:
    """B3's arithmetic for a cost of ``cost_dtype`` and ``params``:
    "float" for an f32 or bf16 cost (B8a); "packed" where the values fit
    signed 16-bit pairs (csrc/sgm.cu's note): an int16 cost and
    accumulator, the 5-path mode (its vertical paths are the one closing
    launch of three directions), D not in (64, 96] (where the int32
    route's three disparities a lane fit D and the packed route's eight
    would idle), whole penalties P1, P2 >= 0, one path's bound plus the
    larger penalty below the sentinel, and the sentinel plus P1 + P2 below
    2^15; else "int32"."""
    if cost_dtype.is_floating_point:
        return "float"
    p1, p2 = integral_penalties(params.p1, params.p2)
    d = params.num_disparities
    fits = (cost_dtype == torch.int16
            and acc_dtype_for_params(cost_dtype, params) == torch.int16
            and params.num_paths == 5
            and not 64 < d <= 96
            and p1 >= 0 and p2 >= 0
            and path_bound(params) + max(p1, p2) < PACKED_SENT
            and PACKED_SENT + p1 + p2 < 2**15)
    return "packed" if fits else "int32"


def horizontal_sweeps_plain(cost: torch.Tensor,
                            params: SGBMParams) -> torch.Tensor:
    """Plain B2: left-to-right plus right-to-left path sums, (B, H, W, D)."""
    acc_dtype = acc_dtype_for_params(cost.dtype, params)
    cost_t = cost.permute(0, 2, 3, 1).contiguous()  # (B, W, D, H)
    acc_t = sgm_sweep_dmajor(cost_t, None, (0,), params.p1, params.p2,
                             False, acc_dtype)
    acc_t = sgm_sweep_dmajor(cost_t, acc_t, (0,), params.p1, params.p2, True)
    return acc_t.permute(0, 3, 1, 2).contiguous()


def vertical_sweeps_wta_plain(cost: torch.Tensor, acc: torch.Tensor,
                              params: SGBMParams,
                              return_margin: bool = False):
    """Plain B3: the mode's vertical sweeps added to ``acc``, then WTA ->
    (B, H, W)."""
    return sgm_vertical_wta_dmajor(cost.permute(0, 1, 3, 2),
                                   acc.permute(0, 1, 3, 2), params,
                                   return_margin=return_margin)


def _check_volume(cost: torch.Tensor, params: SGBMParams) -> None:
    _build.require(cost, torch.int16, 4, "sgm cost")
    if cost.shape[-1] != params.num_disparities or cost.shape[-1] > 128:
        raise ValueError("sgm: last axis must be num_disparities <= 128")
    vertical_directions(params.num_paths)
    check_integer_totals(params)


def _vertical_steps(num_paths: int) -> tuple:
    """Sweep steps ``dy`` of the vertical launches of a mode: none for 2
    paths, top-down for 5, top-down then bottom-up for 4 and 8."""
    return {2: (), 5: (1,)}.get(num_paths, (1, -1))


def _horizontal(lib, cost, acc, p1: float, p2: float, stream) -> None:
    """One horizontal launch (B2, or B8a's pair) into ``acc``."""
    global horizontal_plan
    b, h, w, d = cost.shape
    plan = (ctypes.c_int * 4)()
    _build.check(lib.v3d_sgm_horizontal(
        cost.data_ptr(), acc.data_ptr(), b, h, w, d, float(p1), float(p2),
        _CODE[cost.dtype], _CODE[acc.dtype], plan, stream),
        "v3d_sgm_horizontal")
    horizontal_plan = tuple(plan)


def horizontal_sweeps(cost: torch.Tensor, params: SGBMParams) -> torch.Tensor:
    """B2: (B, H, W, D) int16 cost -> sum of both horizontal paths, int16 or
    f32 by :func:`acc_dtype_for_params`. On the card both directions run in
    one launch."""
    global sweep_launches
    if not cost.is_cuda:
        return horizontal_sweeps_plain(cost, params)
    _check_volume(cost, params)
    p1, p2 = integral_penalties(params.p1, params.p2)
    acc = torch.empty(cost.shape, dtype=acc_dtype_for_params(cost.dtype,
                                                              params),
                      device=cost.device)
    _horizontal(_build.lib(), cost, acc, p1, p2, _build.stream_of(cost))
    sweep_launches += 1
    return acc


def vertical_sweeps_wta(cost: torch.Tensor, acc: torch.Tensor,
                        params: SGBMParams, return_margin: bool = False):
    """B3: the vertical paths of ``params.num_paths`` -- top-down for 5
    paths, top-down then bottom-up for 4 and 8, none for 2 -- added to the
    horizontal ``acc``, then WTA: the validated disparity (B, H, W) f32,
    plus the uniqueness margin with ``return_margin``.

    On the card every direction of a sweep step runs in one launch and the
    closing launch does the WTA on the total in registers, so the total is
    never stored: ``acc`` is left as it was at 2 and 5 paths and holds
    the horizontal plus top-down sums at 4 and 8 (updated in place). No
    caller may read the total from it. The arithmetic is
    :func:`vertical_route`'s; both integer routes give the same bits.
    """
    global wta_launches, vertical_packed_launches
    if not cost.is_cuda:
        return vertical_sweeps_wta_plain(cost, acc, params, return_margin)
    _check_volume(cost, params)
    _build.require(acc, acc_dtype_for_params(cost.dtype, params), 4,
                   "sgm acc")
    if acc.shape != cost.shape:
        raise ValueError("sgm: acc and cost shapes differ")
    packed = vertical_route(cost.dtype, params) == "packed"
    disp, margin, rkey = vertical_launches(cost, acc, params, return_margin,
                                           packed)
    if rkey is not None:
        b, h, w, d = cost.shape
        _build.check(_build.lib().v3d_sgm_lr_check(
            disp.data_ptr(), rkey.data_ptr(), b, h, w, d,
            int(params.min_disparity), int(params.disp12_max_diff),
            int(packed), _build.stream_of(cost)), "v3d_sgm_lr_check")
    wta_launches += 1
    vertical_packed_launches += packed
    return (disp, margin) if return_margin else disp


def vertical_launches(cost: torch.Tensor, acc: torch.Tensor,
                      params: SGBMParams, return_margin: bool,
                      packed: bool) -> tuple:
    """B3's vertical launches of a checked call of
    :func:`vertical_sweeps_wta` on the packed route or the int32 one:
    (disparity before the LR check, margin or None, the strips'
    right-image keys or None). ``packed`` only where :func:`vertical_route`
    gives "packed"; the card's checks run both routes on such inputs."""
    global vertical_plan
    p1, p2 = integral_penalties(params.p1, params.p2)
    lib = _build.lib()
    stream = _build.stream_of(cost)
    b, h, w, d = cost.shape
    dev = cost.device
    lr = int(params.disp12_max_diff)
    n_dirs = len(vertical_shifts(params.num_paths))
    disp = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    margin = torch.empty_like(disp) if return_margin else None
    rkey = (torch.empty(b * lib.v3d_sgm_vertical_keys(b, h, w, d,
                                                      int(packed)),
                        dtype=torch.int32, device=dev) if lr >= 0 else None)
    xch = (torch.empty(lib.v3d_sgm_vertical_scratch(b, w, _CODE[cost.dtype]),
                       dtype=torch.int32, device=dev)
           if n_dirs == 3 else None)
    plan = (ctypes.c_int * 6)()
    steps = _vertical_steps(params.num_paths) or (1,)  # 2 paths: WTA alone
    for dy in steps:
        close = dy == steps[-1]
        _build.check(lib.v3d_sgm_vertical(
            cost.data_ptr(), acc.data_ptr(), disp.data_ptr(),
            None if margin is None else margin.data_ptr(),
            None if rkey is None else rkey.data_ptr(),
            None if xch is None else xch.data_ptr(), b, h, w, d, n_dirs, dy,
            int(close), float(p1), float(p2), int(params.min_disparity),
            int(params.uniqueness_ratio), lr, _CODE[cost.dtype],
            _CODE[acc.dtype], int(packed), plan, stream), "v3d_sgm_vertical")
    if n_dirs == 3:
        vertical_plan = tuple(plan)
    return disp, margin, rkey


def sgm_aggregate_pallas(cost: torch.Tensor, num_paths: int = 8,
                         p1: float = 600.0, p2: float = 2400.0
                         ) -> torch.Tensor:
    """B8a: sum of the directional SGM path costs over 2, 4, 5 or 8 paths
    of a (B, H, W, D) f32 or bf16 cost, as f32 (B, H, W, D); the port's
    ``sgm_aggregate_pallas`` (the JAX package's public kernel API, same
    arguments less ``interpret``). The twin is
    :func:`video3d_tpu_torch.ops.stereo.sgm_aggregate`.

    On the card B2's kernel runs the horizontal pair in one launch and B3's
    one launch per vertical sweep step, each storing the f32 total: 1, 2
    or 3 launches at 2, 5 or 4 and 8 paths (a launch of the 3-direction
    sweeps runs in chunks of frames where the batch does not fit the card
    at once)."""
    global aggregate_launches, vertical_plan, aggregate_plan
    params = SGBMParams(num_paths=num_paths, p1=p1, p2=p2)
    if not cost.is_cuda:
        return sgm_aggregate(cost, params)
    if cost.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sgm_aggregate_pallas: f32 or bf16 cost, got "
                         f"{cost.dtype}")
    _build.require(cost, cost.dtype, 4, "sgm_aggregate_pallas cost")
    if cost.shape[-1] > 128:
        raise ValueError("sgm_aggregate_pallas: at most 128 disparities")
    n_dirs = len(vertical_shifts(num_paths))
    lib = _build.lib()
    stream = _build.stream_of(cost)
    b, h, w, d = cost.shape
    dev = cost.device
    code = _CODE[cost.dtype]
    acc = torch.empty(cost.shape, dtype=torch.float32, device=dev)
    _horizontal(lib, cost, acc, p1, p2, stream)
    xch = (torch.empty(lib.v3d_sgm_vertical_scratch(b, w, code),
                       dtype=torch.int32, device=dev)
           if n_dirs == 3 else None)
    plan = (ctypes.c_int * 6)()
    steps = _vertical_steps(num_paths)
    for dy in steps:
        _build.check(lib.v3d_sgm_vertical(
            cost.data_ptr(), acc.data_ptr(), None, None, None,
            None if xch is None else xch.data_ptr(), b, h, w, d, n_dirs, dy,
            0, float(p1), float(p2), 0, 0, -1, code, _CODE[torch.float32],
            0, plan, stream), "v3d_sgm_vertical")
    chunks = 1
    if n_dirs == 3:
        vertical_plan = tuple(plan)
        chunks = plan[4]
    aggregate_plan = (1 + len(steps) * chunks, len(steps))
    aggregate_launches += 1
    return acc


def sgm_aggregate_pallas_dmajor(cost: torch.Tensor, num_paths: int = 8,
                                p1: float = 600.0, p2: float = 2400.0
                                ) -> torch.Tensor:
    """SGM path aggregation, D-major: (B, H, D, W) f32 or bf16 cost ->
    (B, H, D, W) f32; :func:`sgm_aggregate_pallas` between two permutes
    (the JAX function only calls B2, so it has no kernel of its own)."""
    out = sgm_aggregate_pallas(cost.transpose(2, 3).contiguous(), num_paths,
                               p1, p2)
    return out.transpose(2, 3).contiguous()
