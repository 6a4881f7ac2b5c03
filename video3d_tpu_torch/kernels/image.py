"""Kernel I1 wrapper: the depth stage's SBS split, 2x Lanczos-4 unsqueeze
and BT.601 gray in one launch.

CUDA source: ``video3d_tpu_torch/csrc/image.cu``. It replaces no TPU
kernel: the JAX stage resamples with a dense matrix product, as the plain
twin :func:`video3d_tpu_torch.ops.image.eyes_gray_plain` does. The kernel
reads the uint8 SBS batch once and writes the two f32 gray eyes and, where
the caller asks, the two f32 RGB eyes. For the unsqueeze it reads the
resampling matrix's non-zero taps as :func:`video3d_tpu_torch.ops.image.
lanczos_taps` gives them, (n_out, 8) indices and weights, and sums each
column's in ascending index order; without it, each output pixel is its
source pixel.
"""

from __future__ import annotations

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.ops.image import eyes_gray_plain, lanczos_taps_on

launches = 0  # calls that launched the CUDA kernel


def eyes_gray(frames: torch.Tensor, unsqueeze: bool = True,
              want_rgb: bool = False):
    """uint8 SBS RGB batch (B, H, W, 3) -> (gray left, gray right, RGB
    left, RGB right).

    The gray eyes are contiguous f32 (B, H, W'), W' = W (unsqueezed) or
    W // 2; the RGB eyes f32 (B, H, W', 3) where ``want_rgb``, else None,
    with the strides of the plain twin's: planar storage (B, 3, H, W')
    seen through ``movedim(1, -1)`` when unsqueezed, (B, H, W', 3)
    contiguous when not. A CUDA tensor runs the kernel (one launch), a CPU
    tensor the plain twin.
    """
    global launches
    if not frames.is_cuda:
        return eyes_gray_plain(frames, unsqueeze, want_rgb)
    _build.require(frames, torch.uint8, 4, "eyes_gray frames")
    b, h, w, ch = frames.shape
    if ch != 3:
        raise ValueError(f"eyes_gray: expected RGB frames, got {ch} channels")
    if w % 2:
        raise ValueError(f"SBS width must be even, got {w}")
    w_in = w // 2
    w_out = 2 * w_in if unsqueeze else w_in
    idx = wts = None
    if unsqueeze:
        idx, wts = lanczos_taps_on(w_in, w_out, frames.device)
    gl, gr = (torch.empty((b, h, w_out), dtype=torch.float32,
                          device=frames.device) for _ in range(2))
    rl = rr = None
    if want_rgb:
        shape = (b, 3, h, w_out) if unsqueeze else (b, h, w_out, 3)
        rl, rr = (torch.empty(shape, dtype=torch.float32,
                              device=frames.device) for _ in range(2))
    lib = _build.lib()
    _build.check(lib.v3d_eyes_gray(
        frames.data_ptr(), gl.data_ptr(), gr.data_ptr(),
        rl.data_ptr() if want_rgb else None,
        rr.data_ptr() if want_rgb else None,
        idx.data_ptr() if unsqueeze else None,
        wts.data_ptr() if unsqueeze else None, b, h, w, int(unsqueeze),
        _build.stream_of(frames)), "v3d_eyes_gray")
    launches += 1
    if want_rgb and unsqueeze:
        rl, rr = rl.movedim(1, -1), rr.movedim(1, -1)
    return gl, gr, rl, rr
