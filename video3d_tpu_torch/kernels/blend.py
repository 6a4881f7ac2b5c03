"""Kernels F1 and F2 wrapper: the depth stage's hole fill and its
confidence-trust blend after the guide's output.

CUDA source: ``video3d_tpu_torch/csrc/blend.cu`` (C entries
``v3d_fill_holes``, ``v3d_trust_blend``, ``v3d_blend_scratch``). They
replace no TPU kernel: the JAX package's fill, box sums and blend are plain
jnp. The plain twins are the port's own plain code:

* :func:`fill_holes` (F1's fill, one launch) sends a CPU tensor to
  :func:`video3d_tpu_torch.ops.fill.fill_holes`;
* :func:`trust_blend` (F1's frame statistics, for a monocular guide F1's
  agreement after the landing, then F2's trust and blend: two launches,
  three for a monocular guide) takes CUDA tensors only;
  :func:`video3d_tpu_torch.stages.depth.guidance_blend` chooses between it
  and its twin :func:`video3d_tpu_torch.stages.depth.blend_plain`, as
  ``ops/flow.py`` does for B5's and B6's fused entries.

``launches`` counts every launch of the source.
"""

from __future__ import annotations

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.ops.fill import fill_holes as fill_holes_plain

launches = 0  # launches of csrc/blend.cu's kernels

# per device: a ticket word a frame, 0 between calls (each frame's last
# block sets its word back); the calls on a device run in the order of its
# stream
_tickets = {}


def fill_holes(disp: torch.Tensor, invalid: float) -> torch.Tensor:
    """(B, H, W) f32 disparity with its holes (``== invalid``) filled by
    the smaller of the nearest valid values left and right in the row.

    A CUDA tensor runs F1's fill, a CPU tensor the plain twin.
    """
    global launches
    if not disp.is_cuda:
        return fill_holes_plain(disp, invalid)
    _build.require(disp, torch.float32, 3, "fill disp")
    b, h, w = disp.shape
    out = torch.empty_like(disp)
    _build.check(_build.lib().v3d_fill_holes(
        disp.data_ptr(), out.data_ptr(), b, h, w, float(invalid),
        _build.stream_of(disp)), "v3d_fill_holes")
    launches += 1
    return out


def _tickets_for(device: torch.device, b: int) -> torch.Tensor:
    buf = _tickets.get(device)
    if buf is None or buf.numel() < b:
        buf = torch.zeros(b, dtype=torch.int32, device=device)
        _tickets[device] = buf
    return buf


def trust_blend(disp: torch.Tensor, margin: torch.Tensor,
                guide: torch.Tensor, every: int, stereo: bool,
                num_disparities: int, min_disparity: float) -> torch.Tensor:
    """The blended disparity (B, H, W) f32 on the card: ``disp`` (after any
    fill) and the matcher's ``margin`` (B, H, W), the guide's output on the
    keyframes ``guide`` (ceil(B / every), H, W), all f32 and contiguous;
    frame i reads keyframe i // every. ``stereo``: the guide gives
    disparity; else it is monocular and is landed first, by the
    scale-and-shift fit onto the confident stereo where its scale is
    positive, else min-max normalised to [0, num_disparities].
    ``stages/depth.py blend_plain`` with ``blend="confidence"`` and
    ``trust_scale=1`` computes the same with plain operations."""
    global launches
    for t, name in ((disp, "blend disp"), (margin, "blend margin"),
                    (guide, "blend guide")):
        _build.require(t, torch.float32, 3, name)
    every = int(every)
    b, h, w = disp.shape
    if margin.shape != disp.shape:
        raise ValueError("trust_blend: margin and disparity shapes differ")
    if every < 1 or guide.shape != (-(-b // every), h, w):
        raise ValueError(
            f"trust_blend: guide {tuple(guide.shape)} is not "
            f"(ceil({b} / {every}), {h}, {w})")
    if margin.device != disp.device or guide.device != disp.device:
        raise ValueError("trust_blend: tensors on different devices")
    lib = _build.lib()
    out = torch.empty_like(disp)
    scratch = torch.empty(lib.v3d_blend_scratch(b, h), dtype=torch.float64,
                          device=disp.device)
    _build.check(lib.v3d_trust_blend(
        disp.data_ptr(), margin.data_ptr(), guide.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), _tickets_for(disp.device, b).data_ptr(), b, h, w,
        every, int(bool(stereo)), float(min_disparity) - 0.5,
        float(num_disparities), _build.stream_of(disp)), "v3d_trust_blend")
    launches += 2 if stereo else 3
    return out
