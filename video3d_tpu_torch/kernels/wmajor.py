"""Kernel B8b and B8c wrappers: the W-major horizontal route of the matcher.

CUDA source: ``video3d_tpu_torch/csrc/wmajor.cu``. B8c replaces the TPU
kernel ``video3d_tpu/kernels/sgm.py _directional_pass_wmajor``: a
horizontal SGM sweep of the W-major ``(B, D, W, HL)`` volume (HL: image
rows, padded or not) with f32 carries. On the card it is one kernel with
two entries: :func:`horizontal_sweeps_wmajor_kernel` runs both directions
in one launch (JAX ``_horizontal_passes_wmajor`` runs two sweeps), and
:func:`wmajor_sweep` one direction, added into a given accumulator. B8b
replaces ``transpose_to_wmajor`` and ``transpose_from_wmajor``: exact
layout changes between the port's ``(B, H, W, D)`` volume and
``(B, D, W, HP)``, HP = H rounded up to 128, whose padding lanes the port
writes as zero (no consumer reads them); one persistent launch a call
moves 64-row by 256-byte tiles through a swizzled shared ring, 16 bytes a
thread on both sides (``csrc/wmajor.cu transpose_kernel``). The JAX
package takes its ``mxu`` transposes only when W % 128 == 0; these take
any width, height and D, element by element where a row is no multiple of
16 bytes or a pointer is not 16-byte aligned. The plain twins
are :func:`wmajor_sweep_plain`, :func:`horizontal_sweeps_wmajor_plain`,
:func:`transpose_to_wmajor_plain` and :func:`transpose_from_wmajor_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.ops.stereo import (SGBMParams, acc_dtype_for_params,
                                          check_integer_totals,
                                          integral_penalties,
                                          sgm_sweep_dmajor)

transpose_launches = 0  # B8b: calls that launched a CUDA transpose
# B8b's last launch: (blocks per multiprocessor, multiprocessors, blocks
# launched, tiles of 64 rows by 256 bytes), or None
transpose_plan = None
sweep_launches = 0  # B8c: launches of the CUDA W-major sweeps, both entries
# B8c's last launch: (blocks per multiprocessor, multiprocessors, blocks
# launched, rounds of row tiles a block takes, rows a tile, shared bytes a
# block), or None
horizontal_plan = None

TILE = 128  # the TPU's lane tile: HP is H rounded up to it

# dtype codes of the C interface, and the (cost, acc) pairs of the sweep
_CODE = {torch.int16: 0, torch.float32: 1}
_SWEEP_TYPES = {(torch.int16, torch.int16), (torch.int16, torch.float32),
                (torch.float32, torch.float32)}


def padded_rows(h: int) -> int:
    """HP: ``h`` rounded up to :data:`TILE`."""
    return -(-h // TILE) * TILE


def transpose_to_wmajor_plain(cost: torch.Tensor) -> torch.Tensor:
    """Plain B8b: (B, H, W, D) -> (B, D, W, HP), zero lanes h >= H."""
    b, h, w, d = cost.shape
    out = torch.zeros((b, d, w, padded_rows(h)), dtype=cost.dtype,
                      device=cost.device)
    out[..., :h] = cost.permute(0, 3, 2, 1)
    return out


def transpose_from_wmajor_plain(acc_t: torch.Tensor, h: int) -> torch.Tensor:
    """Plain B8b inverse: (B, D, W, HP) -> (B, H, W, D), rows < ``h``."""
    return acc_t[..., :h].permute(0, 3, 2, 1).contiguous()


def _transpose(x: torch.Tensor, out: torch.Tensor, h: int,
               to_wmajor: bool) -> torch.Tensor:
    global transpose_launches, transpose_plan
    if x.dtype not in _CODE:
        raise ValueError(f"wmajor transpose: int16 or f32, got {x.dtype}")
    _build.require(x, x.dtype, 4, "wmajor transpose")
    b, d, w, hp = out.shape if to_wmajor else x.shape
    plan = (ctypes.c_int * 4)()
    _build.check(_build.lib().v3d_wmajor_transpose(
        x.data_ptr(), out.data_ptr(), b, h, w, d, hp, x.element_size(),
        int(to_wmajor), plan, _build.stream_of(x)), "v3d_wmajor_transpose")
    transpose_plan = tuple(plan)
    transpose_launches += 1
    return out


def transpose_to_wmajor(cost: torch.Tensor) -> torch.Tensor:
    """B8b: (B, H, W, D) int16 or f32 -> (B, D, W, HP), exact."""
    if not cost.is_cuda:
        return transpose_to_wmajor_plain(cost)
    b, h, w, d = cost.shape
    out = torch.empty((b, d, w, padded_rows(h)), dtype=cost.dtype,
                      device=cost.device)
    return _transpose(cost, out, h, True)


def transpose_from_wmajor(acc_t: torch.Tensor, h: int) -> torch.Tensor:
    """B8b inverse: (B, D, W, HP) int16 or f32 -> (B, H, W, D), exact."""
    if not acc_t.is_cuda:
        return transpose_from_wmajor_plain(acc_t, h)
    b, d, w, hp = acc_t.shape
    if not 0 < h <= hp:
        raise ValueError(f"transpose_from_wmajor: h={h} outside (0, {hp}]")
    out = torch.empty((b, h, w, d), dtype=acc_t.dtype, device=acc_t.device)
    return _transpose(acc_t, out, h, False)


def wmajor_sweep_plain(cost_t: torch.Tensor, acc_t, p1: float, p2: float,
                       reverse: bool,
                       acc_dtype: torch.dtype = torch.int16) -> torch.Tensor:
    """Plain B8c: one horizontal sweep along W of (B, D, W, HL), added into
    ``acc_t`` (a fresh accumulation of ``acc_dtype`` when None)."""
    acc = None if acc_t is None else acc_t.permute(0, 2, 1, 3)
    out = sgm_sweep_dmajor(cost_t.permute(0, 2, 1, 3), acc, (0,), p1, p2,
                           reverse, acc_dtype)  # (B, W, D, HL)
    return out.permute(0, 2, 1, 3).contiguous()


def horizontal_sweeps_wmajor_plain(cost_t: torch.Tensor, p1: float,
                                   p2: float,
                                   acc_dtype: torch.dtype = torch.int16
                                   ) -> torch.Tensor:
    """Plain B8c, both directions: the left-to-right sweep of the
    (B, D, W, HL) cost into a fresh ``acc_dtype`` accumulator, then the
    right-to-left one added to it (JAX ``_horizontal_passes_wmajor``
    between its layout changes)."""
    acc_t = wmajor_sweep_plain(cost_t, None, p1, p2, False, acc_dtype)
    return wmajor_sweep_plain(cost_t, acc_t, p1, p2, True)


def _sweep_args(cost_t: torch.Tensor, acc_dtype: torch.dtype, p1: float,
                p2: float) -> tuple:
    """Check what B8c takes; its penalties as the kernel reads them."""
    if (cost_t.dtype, acc_dtype) not in _SWEEP_TYPES:
        raise ValueError(f"wmajor sweep: no kernel for a {cost_t.dtype} cost "
                         f"into a {acc_dtype} accumulator")
    _build.require(cost_t, cost_t.dtype, 4, "wmajor cost")
    if cost_t.shape[1] > 128:
        raise ValueError("wmajor sweep: at most 128 disparities")
    if cost_t.dtype == torch.int16:
        p1, p2 = integral_penalties(p1, p2)
    return float(p1), float(p2)


def _launched(err: int, name: str, plan) -> None:
    global sweep_launches, horizontal_plan
    _build.check(err, name)
    horizontal_plan = tuple(plan)
    sweep_launches += 1


def horizontal_sweeps_wmajor_kernel(cost_t: torch.Tensor, p1: float,
                                    p2: float,
                                    acc_dtype: torch.dtype = torch.int16
                                    ) -> torch.Tensor:
    """B8c, both directions: the sum of the left-to-right and the
    right-to-left sweep of the (B, D, W, HL) int16 or f32 cost, as a new
    ``acc_dtype`` volume (int16 or f32 for an int16 cost, f32 for an f32
    one). One launch on the card."""
    if not cost_t.is_cuda:
        return horizontal_sweeps_wmajor_plain(cost_t, p1, p2, acc_dtype)
    p1, p2 = _sweep_args(cost_t, acc_dtype, p1, p2)
    b, d, w, hl = cost_t.shape
    acc_t = torch.empty(cost_t.shape, dtype=acc_dtype, device=cost_t.device)
    plan = (ctypes.c_int * 6)()
    _launched(_build.lib().v3d_wmajor_horizontal(
        cost_t.data_ptr(), acc_t.data_ptr(), b, d, w, hl, p1, p2,
        _CODE[cost_t.dtype], _CODE[acc_dtype], plan,
        _build.stream_of(cost_t)), "v3d_wmajor_horizontal", plan)
    return acc_t


def wmajor_sweep(cost_t: torch.Tensor, acc_t, p1: float, p2: float,
                 reverse: bool,
                 acc_dtype: torch.dtype = torch.int16) -> torch.Tensor:
    """B8c, one direction: a horizontal sweep (left to right, or right to
    left with ``reverse``) of the (B, D, W, HL) int16 or f32 cost, added
    into ``acc_t`` (in place on the card) or into a fresh ``acc_dtype``
    accumulator: int16 or f32 for an int16 cost, f32 for an f32 one."""
    if acc_t is not None:
        acc_dtype = acc_t.dtype
    if not cost_t.is_cuda:
        return wmajor_sweep_plain(cost_t, acc_t, p1, p2, reverse, acc_dtype)
    p1, p2 = _sweep_args(cost_t, acc_dtype, p1, p2)
    b, d, w, hl = cost_t.shape
    if acc_t is None:
        acc_t = torch.empty(cost_t.shape, dtype=acc_dtype,
                            device=cost_t.device)
        acc_in = None
    else:
        _build.require(acc_t, acc_dtype, 4, "wmajor acc")
        if acc_t.shape != cost_t.shape:
            raise ValueError("wmajor sweep: acc and cost shapes differ")
        acc_in = acc_t.data_ptr()
    plan = (ctypes.c_int * 6)()
    _launched(_build.lib().v3d_wmajor_sweep(
        cost_t.data_ptr(), acc_in, acc_t.data_ptr(), b, d, w, hl, p1, p2,
        int(reverse), _CODE[cost_t.dtype], _CODE[acc_dtype], plan,
        _build.stream_of(cost_t)), "v3d_wmajor_sweep", plan)
    return acc_t


def horizontal_sweeps_wmajor(cost: torch.Tensor, params: SGBMParams,
                             route: str = "xla") -> torch.Tensor:
    """Both horizontal sweeps of the (B, H, W, D) int16 cost on the W-major
    layout (JAX ``_horizontal_passes_wmajor``): into (B, D, W, H) by
    ``permute().contiguous()`` for ``route="xla"``, into (B, D, W, HP) by
    B8b for ``"mxu"``, both sweeps in one B8c launch, and back. Equal to
    B2's :func:`video3d_tpu_torch.kernels.sgm.horizontal_sweeps`."""
    if route not in ("xla", "mxu"):
        raise ValueError(f"W-major route must be xla or mxu: {route!r}")
    check_integer_totals(params)
    acc_dtype = acc_dtype_for_params(cost.dtype, params)
    h = cost.shape[1]
    if route == "mxu":
        cost_t = transpose_to_wmajor(cost)
    else:
        cost_t = cost.permute(0, 3, 2, 1).contiguous()  # (B, D, W, H)
    acc_t = horizontal_sweeps_wmajor_kernel(cost_t, params.p1, params.p2,
                                            acc_dtype)
    if route == "mxu":
        return transpose_from_wmajor(acc_t, h)
    return acc_t.permute(0, 3, 2, 1).contiguous()
