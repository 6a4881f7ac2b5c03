"""Plain image ops of the reference: SBS split, OpenCV-aligned Lanczos-4
and bilinear resampling matrices, BT.601 gray.

``mode`` says in what precision: ``"f64"`` (the reference: float64
throughout) or ``"low"`` (the control, one step below the float32 the
configurations state: a resample's operands rounded to TF32's 10-bit
mantissa and summed in float32, as with TF32 on; the gray conversion in
bfloat16).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

LUMA_RGB = (0.299, 0.587, 0.114)  # BT.601, OpenCV's RGB2GRAY


def _lanczos(t: np.ndarray, a: int) -> np.ndarray:
    out = np.sinc(t) * np.sinc(t / a)
    out[np.abs(t) >= a] = 0.0
    return out


@lru_cache(maxsize=16)
def resample_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_in, n_out) float64 matrix, columns summing to 1: ``src @ M``
    resamples the last axis with OpenCV's centre alignment (edge taps
    clamped), ``lanczos4`` (a = 4) or ``bilinear``."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    base = np.floor(src).astype(np.int64)
    cols = np.arange(n_out)
    mat = np.zeros((n_in, n_out), dtype=np.float64)
    if method == "lanczos4":
        for k in range(-3, 5):
            idx = base + k
            np.add.at(mat, (np.clip(idx, 0, n_in - 1), cols),
                      _lanczos(src - idx, 4))
    elif method == "bilinear":
        frac = src - base
        np.add.at(mat, (np.clip(base, 0, n_in - 1), cols), 1.0 - frac)
        np.add.at(mat, (np.clip(base + 1, 0, n_in - 1), cols), frac)
    else:
        raise ValueError(f"unknown resample method: {method}")
    return mat / mat.sum(axis=0, keepdims=True)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10 mantissa
    bits."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "f64":
        return torch.matmul(a.to(torch.float64), b.to(torch.float64))
    if mode == "low":
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return torch.matmul(to_tf32(a), to_tf32(b))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    raise ValueError(f"unknown precision mode: {mode}")


def resize_width(x: torch.Tensor, w_out: int, method: str,
                 mode: str) -> torch.Tensor:
    """Resample the last axis of (..., H, W) to ``w_out``."""
    mat = torch.from_numpy(resample_matrix(x.shape[-1], w_out, method))
    return _product(x, mat.to(x.device), mode)


def resize2d(x: torch.Tensor, h_out: int, w_out: int, method: str,
             mode: str) -> torch.Tensor:
    """Separable resize of (..., H, W): the height, then the width."""
    if x.shape[-2] != h_out:
        mat = torch.from_numpy(resample_matrix(x.shape[-2], h_out, method))
        x = _product(mat.t().to(x.device), x, mode)
    if x.shape[-1] != w_out:
        x = resize_width(x, w_out, method, mode)
    return x


def eyes(frames: torch.Tensor, unsqueeze: bool, mode: str):
    """uint8 SBS (B, H, W, 3) -> RGB eyes (B, H, W', 3), each channel's
    width unsqueezed 2x by Lanczos-4 where ``unsqueeze``; float64, or
    float32 in ``low`` mode."""
    half = frames.shape[2] // 2
    out = []
    for e in (frames[:, :, :half], frames[:, :, half:]):
        e = e.to(torch.float64 if mode == "f64" else torch.float32)
        if unsqueeze:
            e = resize_width(e.movedim(-1, 1), 2 * half, "lanczos4",
                             mode).movedim(1, -1)
        out.append(e)
    return out


def gray(rgb: torch.Tensor, mode: str) -> torch.Tensor:
    """(..., 3) RGB -> (...) BT.601 luma: float64, or computed in bfloat16
    and returned as float32 in ``low`` mode."""
    if mode == "low":
        rgb = rgb.to(torch.bfloat16)
    y = (LUMA_RGB[0] * rgb[..., 0] + LUMA_RGB[1] * rgb[..., 1]
         + LUMA_RGB[2] * rgb[..., 2])
    return y.to(torch.float32) if mode == "low" else y
