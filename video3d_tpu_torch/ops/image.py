"""Batched image ops: SBS split, Lanczos width resampling, BT.601 gray.

Counterpart of :mod:`video3d_tpu.ops.image`. The resamplers are one f32
``torch.matmul`` against the same host-built interpolation matrix; the
callers keep TF32 off (``torch.backends.cuda.matmul.allow_tf32`` False,
PyTorch's default) so the product stays full f32. The depth stage's
split, unsqueeze and gray run on a CUDA device as one kernel
(:mod:`video3d_tpu_torch.kernels.image`) on the non-zero taps of the same
matrix (:func:`lanczos_taps`); :func:`eyes_gray_plain` is its plain twin.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# BT.601 luma weights, same as OpenCV RGB2GRAY (reference depth.py:337-338).
_LUMA_RGB = (0.299, 0.587, 0.114)


def rgb_to_gray(frames: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) RGB -> (..., H, W) float32 luma in the input's scale."""
    f = frames.to(torch.float32)
    return (
        _LUMA_RGB[0] * f[..., 0]
        + _LUMA_RGB[1] * f[..., 1]
        + _LUMA_RGB[2] * f[..., 2]
    )


def split_sbs(frames: torch.Tensor):
    """Split side-by-side frames (..., H, W[, C]) into (left, right) views."""
    axis = -2 if frames.shape[-1] in (1, 3) and frames.ndim >= 3 else -1
    width = frames.shape[axis]
    if width % 2 != 0:
        raise ValueError(f"SBS width must be even, got {width}")
    left, right = torch.split(frames, width // 2, dim=axis)
    return left, right


def _lanczos(t: np.ndarray, a: int) -> np.ndarray:
    out = np.sinc(t) * np.sinc(t / a)
    out[np.abs(t) >= a] = 0.0
    return out


@lru_cache(maxsize=64)
def resample_matrix(n_in: int, n_out: int, method: str = "lanczos4") -> np.ndarray:
    """(n_in, n_out) float32 interpolation matrix, columns summing to 1.

    ``resampled = src @ M`` resamples the last axis from n_in to n_out with
    OpenCV's centre alignment; 'lanczos4' (a=4) or 'bilinear'. A copy of
    the JAX package's matrix, pinned equal to it by test.
    """
    scale = n_in / n_out
    x_out = np.arange(n_out, dtype=np.float64)
    src = (x_out + 0.5) * scale - 0.5
    mat = np.zeros((n_in, n_out), dtype=np.float64)
    if method == "lanczos4":
        a = 4
        base = np.floor(src).astype(np.int64)
        for k in range(-a + 1, a + 1):
            idx = base + k
            w = _lanczos(src - idx, a)
            np.add.at(mat, (np.clip(idx, 0, n_in - 1), np.arange(n_out)), w)
    elif method == "bilinear":
        base = np.floor(src).astype(np.int64)
        frac = src - base
        lo = np.clip(base, 0, n_in - 1)
        hi = np.clip(base + 1, 0, n_in - 1)
        np.add.at(mat, (lo, np.arange(n_out)), 1.0 - frac)
        np.add.at(mat, (hi, np.arange(n_out)), frac)
    else:
        raise ValueError(f"Unknown resample method: {method}")
    mat /= mat.sum(axis=0, keepdims=True)
    return mat.astype(np.float32)


@lru_cache(maxsize=64)
def _resample_matrix_on(n_in: int, n_out: int, method: str,
                        device: torch.device) -> torch.Tensor:
    """The matrix, uploaded once per device: a per-call upload from
    pageable memory blocks the host (0.86 ms per 960->1920 matrix on an
    H100 host, two per batch)."""
    return torch.from_numpy(resample_matrix(n_in, n_out, method)).to(device)


@lru_cache(maxsize=64)
def bilinear_taps(n_in: int, n_out: int) -> tuple:
    """The two taps of each column of ``resample_matrix(n_in, n_out,
    "bilinear")``: (n_out, 2) int32 source indices, ascending, and (n_out,
    2) float32 weights, the matrix's own entries (a column with one
    non-zero entry gets a second tap of weight 0 on the same index). The
    flow kernels resample through these instead of the dense matrix."""
    mat = resample_matrix(n_in, n_out, "bilinear")
    idx = np.zeros((n_out, 2), dtype=np.int32)
    w = np.zeros((n_out, 2), dtype=np.float32)
    for o in range(n_out):
        nz = np.flatnonzero(mat[:, o])
        if len(nz) > 2:
            raise ValueError(f"bilinear column {o} has {len(nz)} taps")
        idx[o] = (nz[0], nz[-1])
        w[o] = (mat[nz[0], o], mat[nz[-1], o] if len(nz) == 2 else 0.0)
    return idx, w


@lru_cache(maxsize=64)
def bilinear_taps_on(n_in: int, n_out: int, device: torch.device) -> tuple:
    """:func:`bilinear_taps` uploaded once per shape and device."""
    idx, w = bilinear_taps(n_in, n_out)
    return torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


@lru_cache(maxsize=64)
def lanczos_taps(n_in: int, n_out: int) -> tuple:
    """The non-zero entries of each column of ``resample_matrix(n_in,
    n_out, "lanczos4")``: (n_out, 8) int32 source indices, ascending, and
    (n_out, 8) float32 weights, the matrix's own entries (clipped border
    indices already merged). A column with fewer than 8 non-zero entries
    is padded with its last index at weight 0."""
    mat = resample_matrix(n_in, n_out, "lanczos4")
    idx = np.zeros((n_out, 8), dtype=np.int32)
    w = np.zeros((n_out, 8), dtype=np.float32)
    for o in range(n_out):
        nz = np.flatnonzero(mat[:, o])
        if len(nz) > 8:
            raise ValueError(f"lanczos4 column {o} has {len(nz)} taps")
        idx[o] = np.concatenate([nz, np.full(8 - len(nz), nz[-1])])
        w[o, :len(nz)] = mat[nz, o]
    return idx, w


@lru_cache(maxsize=64)
def lanczos_taps_on(n_in: int, n_out: int, device: torch.device) -> tuple:
    """:func:`lanczos_taps` uploaded once per shape and device."""
    idx, w = lanczos_taps(n_in, n_out)
    return torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


def resize_width(img: torch.Tensor, w_out: int,
                 method: str = "lanczos4") -> torch.Tensor:
    """Resample the last (width) axis of (..., H, W) via one f32 matmul."""
    mat = _resample_matrix_on(int(img.shape[-1]), w_out, method, img.device)
    return torch.matmul(img.to(torch.float32), mat)


def resize_height(img: torch.Tensor, h_out: int,
                  method: str = "lanczos4") -> torch.Tensor:
    """Resample the second-to-last (height) axis of (..., H, W): one f32
    matmul of the transposed matrix from the left, so the result is
    contiguous."""
    mat = _resample_matrix_on(int(img.shape[-2]), h_out, method, img.device)
    return torch.matmul(mat.t(), img.to(torch.float32))


def resize2d(img: torch.Tensor, h_out: int, w_out: int,
             method: str = "lanczos4") -> torch.Tensor:
    """Separable 2-D resize of (..., H, W) -> (..., h_out, w_out), f32."""
    out = img.to(torch.float32)
    if int(img.shape[-2]) != h_out:
        out = resize_height(out, h_out, method)
    if int(img.shape[-1]) != w_out:
        out = resize_width(out, w_out, method)
    return out


def unsqueeze_width(img: torch.Tensor, method: str = "lanczos4") -> torch.Tensor:
    """Anamorphic 2x horizontal unsqueeze (reference depth.py:263-266)."""
    return resize_width(img, int(img.shape[-1]) * 2, method)


def rgb_eyes(frames: torch.Tensor, unsqueeze: bool = True):
    """uint8 SBS RGB batch (B, H, W, 3) -> f32 RGB eyes (B, H, W', 3):
    split and optional 2x Lanczos-4 unsqueeze of each channel."""
    left, right = split_sbs(frames)
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    if unsqueeze:
        # resample each RGB channel's width: (B, H, W/2, 3) -> (B, H, W, 3)
        left = unsqueeze_width(left.movedim(-1, 1)).movedim(1, -1)
        right = unsqueeze_width(right.movedim(-1, 1)).movedim(1, -1)
    return left, right


def eyes_gray_plain(frames: torch.Tensor, unsqueeze: bool = True,
                    want_rgb: bool = False):
    """uint8 SBS RGB batch (B, H, W, 3) -> (gray left, gray right, RGB
    left, RGB right): the contiguous f32 BT.601 eyes (B, H, W') of
    :func:`rgb_eyes`, and its f32 RGB eyes (B, H, W', 3) where
    ``want_rgb``, else None. The plain twin of
    :func:`video3d_tpu_torch.kernels.image.eyes_gray`."""
    left, right = rgb_eyes(frames, unsqueeze)
    gl = rgb_to_gray(left).contiguous()
    gr = rgb_to_gray(right).contiguous()
    return (gl, gr, left, right) if want_rgb else (gl, gr, None, None)
