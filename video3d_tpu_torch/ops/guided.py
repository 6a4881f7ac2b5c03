"""Guided-filter depth upscaling (He et al.), from
:mod:`video3d_tpu.ops.guided`.

The fast guided filter: linear coefficients (a, b) solved at depth
resolution against the bilinearly downsampled guide, box-filtered,
bilinearly upsampled and applied to the full-resolution guide,
``q = a_up * I + b_up``. The box filters are border-clipped cumulative
sums (:mod:`video3d_tpu_torch.ops.boxsum`) over the true window area,
accumulated in f64 (:func:`_box_sum`); the resizes are the f32 matmuls of
:func:`video3d_tpu_torch.ops.image.resize2d` (the callers keep TF32 off).
All functions take torch tensors and run on their device; the JAX package
computes the same plain products outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from video3d_tpu_torch.ops.boxsum import box_sum_2d, window_area
from video3d_tpu_torch.ops.image import resize2d, rgb_to_gray


def _box_sum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """:func:`box_sum_2d` of ``x`` accumulated in f64, returned in f32.

    A window's sum is the difference of two running sums along a row or
    column. In f32 those running sums lose the small windows' sums: the
    adaptive weight's squared depth gradients reach 1e10 a pixel, and the
    CUDA scan and the CPU's serial sum round them differently (on an H100
    the f32 form moved the 4K adaptive upscale by up to 120 uint16 units
    against the CPU; in f64 both agree within 1). The JAX package sums in
    f32."""
    return box_sum_2d(x.to(torch.float64), radius).to(torch.float32)


def box_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Mean over a (2r+1)^2 window of the last two axes, divided by the
    border-clipped window area."""
    summed = _box_sum(x.to(torch.float32), radius)
    return summed / window_area(x.shape[-2], x.shape[-1], radius, x.device)


def guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int = 8,
                  eps: float = 1e-3) -> torch.Tensor:
    """Gray-guide guided filter at one resolution; ``guide`` and ``src``
    (..., H, W) f32 in [0, 1]."""
    mean_i = box_filter(guide, radius)
    mean_p = box_filter(src, radius)
    var_i = box_filter(guide * guide, radius) - mean_i * mean_i
    cov_ip = box_filter(guide * src, radius) - mean_i * mean_p
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return box_filter(a, radius) * guide + box_filter(b, radius)


def _quantize(q: torch.Tensor, out_dtype: str) -> torch.Tensor:
    """Scale [0, 1] to [0, 65535], then round half up (+0.5, truncate) to
    ``uint16``, or to the top 8 bits (``/257``) as ``uint8``; ``float32``
    returns the scaled values. The cast goes through int32, which truncates
    as the JAX ``astype`` does on these non-negative values."""
    q = torch.clamp(q * 65535.0, 0.0, 65535.0)
    if out_dtype == "uint16":
        return (q + 0.5).to(torch.int32).to(torch.uint16)
    if out_dtype == "uint8":
        return (q / 257.0 + 0.5).to(torch.int32).to(torch.uint8)
    return q


def guided_upsample(depth: torch.Tensor, guide_rgb: torch.Tensor, out_h: int,
                    out_w: int, radius: int = 8, eps: float = 1e-3,
                    guide_mode: str = "gray",
                    out_dtype: str = "float32") -> torch.Tensor:
    """Fast guided upsample of uint16-scale depth (B, h, w) with the guide
    (B, out_h, out_w, 3) in [0, 255] to (B, out_h, out_w).

    ``guide_mode='gray'`` solves a scalar ``a`` on the luma; there the
    guide may also be a precomputed luma plane (B, out_h, out_w).
    ``guide_mode='color'`` solves a 3-vector per pixel from the closed-form
    inverse of the regularised 3x3 RGB covariance. ``out_dtype``
    (float32|uint16|uint8) picks :func:`_quantize`'s output.
    """
    h, w = int(depth.shape[-2]), int(depth.shape[-1])
    p = depth.to(torch.float32) / 65535.0

    if guide_mode == "gray":
        if guide_rgb.ndim == depth.ndim:  # precomputed luma plane
            guide_full = guide_rgb.to(torch.float32) / 255.0
        else:
            guide_full = rgb_to_gray(guide_rgb) / 255.0
        guide_lo = resize2d(guide_full, h, w, method="bilinear")
        mean_i = box_filter(guide_lo, radius)
        mean_p = box_filter(p, radius)
        var_i = box_filter(guide_lo * guide_lo, radius) - mean_i * mean_i
        cov_ip = box_filter(guide_lo * p, radius) - mean_i * mean_p
        a = cov_ip / (var_i + eps)
        b = mean_p - a * mean_i
        a_up = resize2d(box_filter(a, radius), out_h, out_w, method="bilinear")
        b_up = resize2d(box_filter(b, radius), out_h, out_w, method="bilinear")
        return _quantize(a_up * guide_full + b_up, out_dtype)

    # color guide: channel planes (B, 3, H, W)
    guide_full = (guide_rgb.to(torch.float32) / 255.0).movedim(-1, 1)
    gf_lo = resize2d(guide_full, h, w, method="bilinear")
    mean_i = box_filter(gf_lo, radius)
    mean_p = box_filter(p, radius)

    def corr(c1, c2):
        return (box_filter(gf_lo[:, c1] * gf_lo[:, c2], radius)
                - mean_i[:, c1] * mean_i[:, c2])

    s_rr = corr(0, 0) + eps
    s_rg = corr(0, 1)
    s_rb = corr(0, 2)
    s_gg = corr(1, 1) + eps
    s_gb = corr(1, 2)
    s_bb = corr(2, 2) + eps
    cov_ip = [box_filter(gf_lo[:, c] * p, radius) - mean_i[:, c] * mean_p
              for c in range(3)]

    # closed-form 3x3 symmetric inverse (adjugate / det)
    c00 = s_gg * s_bb - s_gb * s_gb
    c01 = s_gb * s_rb - s_rg * s_bb
    c02 = s_rg * s_gb - s_gg * s_rb
    c11 = s_rr * s_bb - s_rb * s_rb
    c12 = s_rg * s_rb - s_rr * s_gb
    c22 = s_rr * s_gg - s_rg * s_rg
    inv_det = 1.0 / (s_rr * c00 + s_rg * c01 + s_rb * c02)
    a0 = (c00 * cov_ip[0] + c01 * cov_ip[1] + c02 * cov_ip[2]) * inv_det
    a1 = (c01 * cov_ip[0] + c11 * cov_ip[1] + c12 * cov_ip[2]) * inv_det
    a2 = (c02 * cov_ip[0] + c12 * cov_ip[1] + c22 * cov_ip[2]) * inv_det
    b = mean_p - a0 * mean_i[:, 0] - a1 * mean_i[:, 1] - a2 * mean_i[:, 2]

    ups = [resize2d(box_filter(x, radius), out_h, out_w, method="bilinear")
           for x in (a0, a1, a2, b)]
    q = (ups[0] * guide_full[:, 0] + ups[1] * guide_full[:, 1]
         + ups[2] * guide_full[:, 2] + ups[3])
    return _quantize(q, out_dtype)


def plain_upsample(depth: torch.Tensor, out_h: int, out_w: int,
                   method: str = "bilinear",
                   out_dtype: str = "float32") -> torch.Tensor:
    """Plain resize of uint16-scale depth, the reference's ffmpeg
    ``scale`` (its upscale.py:50)."""
    out = resize2d(depth.to(torch.float32), out_h, out_w, method=method)
    return _quantize(out / 65535.0, out_dtype)


def _grad_mag(x: torch.Tensor) -> torch.Tensor:
    """|d/dx| + |d/dy| with the first column and row differenced against
    themselves (0), as ``jnp.diff(..., prepend=x[..., :1])``."""
    dx = torch.diff(x, dim=-1, prepend=x[..., :1]).abs()
    dy = torch.diff(x, dim=-2, prepend=x[..., :1, :]).abs()
    return dx + dy


def adaptive_upsample(depth: torch.Tensor, guide_rgb: torch.Tensor,
                      out_h: int, out_w: int, radius: int = 8,
                      eps: float = 1e-3, corr_radius: int = 2,
                      out_dtype: str = "float32") -> torch.Tensor:
    """Per-pixel mix of the color guided upsample and the plain one (the
    upscale stage's default).

    The weight is the local normalised correlation, in a box of
    ``corr_radius`` at depth resolution, of the depth's and the
    downsampled luma's gradient magnitudes, clipped to [0, 1] and resized
    bilinearly: where the guide tracks the depth's edges the guided output
    is used, elsewhere plain interpolation.
    """
    h_lo, w_lo = depth.shape[-2], depth.shape[-1]
    gl_lo = resize2d(rgb_to_gray(guide_rgb), h_lo, w_lo, method="bilinear")
    gd = _grad_mag(depth.to(torch.float32))
    gg = _grad_mag(gl_lo)
    num = _box_sum(gd * gg, corr_radius)
    den = torch.sqrt(_box_sum(gd * gd, corr_radius)
                     * _box_sum(gg * gg, corr_radius)) + 1e-6
    w = resize2d(torch.clamp(num / den, 0.0, 1.0), out_h, out_w,
                 method="bilinear")
    up_g = guided_upsample(depth, guide_rgb, out_h, out_w, radius=radius,
                           eps=eps, guide_mode="color")
    up_p = plain_upsample(depth, out_h, out_w)
    return _quantize((w * up_g + (1.0 - w) * up_p) / 65535.0, out_dtype)
