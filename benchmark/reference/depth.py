"""The reference depth step: a batch of SBS frames -> uint16 depth maps, by
the configuration's semantics, independent of the program.

Per frame: split the eyes, unsqueeze a half-SBS eye 2x (Lanczos-4), BT.601
gray, the matcher (:mod:`benchmark.reference.matcher`), with guidance the
background-extension hole fill, the keyframe guide (every
``guidance_every``-th frame of the batch serves itself and the frames after
it) and the confidence-trust blend, then fixed-range or per-frame uint16.
Floating steps run in float64 except the guide's network, which runs in
the precision the configuration states (bfloat16 convolutions, see
:mod:`benchmark.reference.crestereo`). ``control=True`` computes every
configured float step of the image ops and the guide one precision lower:
TF32 resampling, bfloat16 gray, fp8 guide convolutions.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference import image, matcher
from benchmark.reference.crestereo import Net, load
from benchmark.reference.matcher import box_clipped

CHUNK = 4  # frames through the matcher at once: its int32 volumes fit


def fill_holes(disp: torch.Tensor, invalid: float) -> torch.Tensor:
    """Each invalid pixel takes the smaller of the nearest valid
    disparities to its left and right in its row; a row with none stays."""
    w = disp.shape[-1]
    valid = disp != invalid
    cols = torch.arange(w, device=disp.device).expand(disp.shape)
    left = torch.where(valid, cols, -1).cummax(dim=-1).values
    right = torch.where(valid, cols, w).flip(-1).cummin(dim=-1).values.flip(-1)
    inf = float("inf")
    lv = torch.where(left >= 0, disp.gather(-1, left.clamp(min=0)), inf)
    rv = torch.where(right < w, disp.gather(-1, right.clamp(max=w - 1)), inf)
    fill = torch.minimum(lv, rv)
    fill = torch.where(torch.isinf(fill), invalid, fill)
    return torch.where(valid, disp, fill)


def trust_blend(disp, conf, guide, min_disparity: float,
                trust_scale: int):
    """Confidence-trust blend: the stereo weight is the match confidence
    where the stereo is valid; low-confidence pixels go to the guide as far
    as the guide agrees (within 2 px) with the confident stereo around
    them: agreeing over confident mass in an r = 8 box, the frame's ratio
    where the box holds under 2% confident mass, full trust where the frame
    holds under 32. ``trust_scale`` s > 1 pools the fields s x s and
    expands the ratio bilinearly."""
    conf = torch.where(disp > min_disparity - 0.5, conf, 0.0)
    stereo = disp.clamp(min=0.0)
    agree = torch.where((guide - stereo).abs() <= 2.0, conf, 0.0)
    mass = conf.sum(dim=(-2, -1), keepdim=True)
    q_frame = torch.where(
        mass >= 32.0,
        agree.sum(dim=(-2, -1), keepdim=True) / mass.clamp(min=1e-6), 1.0)
    b, h, w = agree.shape
    s = int(trust_scale)
    if s > 1:
        hq, wq = h // s, w // s

        def pool(a):
            return a[:, :hq * s, :wq * s].reshape(b, hq, s, wq,
                                                  s).sum(dim=(2, 4))

        r = max(1, 8 // s)
        num, den = box_clipped(pool(agree), r), box_clipped(pool(conf), r)
        area = box_clipped(torch.full_like(num[:1], float(s * s)), r)
        trust = torch.where(den > 0.02 * area, num / den.clamp(min=1e-6),
                            q_frame)
        trust = image.resize2d(trust, h, w, "bilinear", "f64")
    else:
        num, den = box_clipped(agree, 8), box_clipped(conf, 8)
        area = box_clipped(torch.ones_like(conf[:1]), 8)
        trust = torch.where(den > 0.02 * area, num / den.clamp(min=1e-6),
                            q_frame)
    conf = 1.0 - (1.0 - conf) * trust.clamp(0.0, 1.0)
    return conf * stereo + (1.0 - conf) * guide


def to_uint16(disp: torch.Tensor, num_disparities: int,
              normalize: str) -> torch.Tensor:
    """Clamp at 0 and scale (0..D, or the frame's min..max) to 0..65535,
    truncated."""
    disp = disp.clamp(min=0.0)
    if normalize == "per_frame":
        lo = disp.amin(dim=(-2, -1), keepdim=True)
        hi = disp.amax(dim=(-2, -1), keepdim=True)
        scaled = (disp - lo) / (hi - lo).clamp(min=1e-6) * 65535.0
    else:
        scaled = disp * (65535.0 / num_disparities)
    return scaled.clamp(0.0, 65535.0).to(torch.int32)


@contextlib.contextmanager
def exact_float32():
    """float32 matrix products and convolutions without TF32, whatever the
    process set; the previous settings come back after."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = prev


class Reference:
    """The reference for one configuration and traffic mix on ``device``;
    ``root`` is the checkout the weights path is relative to."""

    def __init__(self, config: dict, traffic: dict, root, device,
                 control: bool = False):
        self.ext = dict(config["extractor"], **traffic["options"])
        self.sgbm = config["sgbm"]
        self.unsqueeze = traffic["format"] == "half_sbs"
        self.every = int(self.ext["guidance_every"])
        self.device = torch.device(device)
        self.image_mode = "low" if control else "f64"
        self.net = None
        if config["guide"] is not None:
            self.net = Net(load(root / config["weights"]), config["guide"],
                           self.device, "fp8" if control else "bf16")

    def maps(self, frames) -> torch.Tensor:
        """uint8 SBS batch (B, H, W, 3), numpy or tensor -> int32 maps
        (B, H, W') holding uint16 values, on the device."""
        with exact_float32():
            return self._maps(torch.as_tensor(frames).to(self.device))

    def _maps(self, frames: torch.Tensor) -> torch.Tensor:
        out = []
        guide = None
        if self.net is not None:
            keys = frames[::self.every]
            lk, rk = image.eyes(keys, self.unsqueeze, self.image_mode)
            guide = self.net.guidance(lk, rk, self.image_mode)
            guide = guide.repeat_interleave(self.every, dim=0)[:len(frames)]
        for i in range(0, len(frames), CHUNK):
            out.append(self._chunk(frames[i:i + CHUNK],
                                   None if guide is None
                                   else guide[i:i + CHUNK]))
        return torch.cat(out)

    def _chunk(self, frames, guide):
        left, right = image.eyes(frames, self.unsqueeze, self.image_mode)
        gl = image.gray(left, self.image_mode)
        gr = image.gray(right, self.image_mode)
        del left, right
        p = self.sgbm
        blend = guide is not None and self.ext["blend"] == "confidence"
        res = matcher.disparity(gl, gr, p, want_confidence=blend,
                                apply_speckle=self.ext["apply_speckle"])
        disp, conf = res if blend else (res, None)
        if self.ext["fill_holes"]:
            disp = fill_holes(disp, float(p["min_disparity"] - 1))
        if guide is not None:
            if blend:
                disp = trust_blend(disp, conf, guide,
                                   float(p["min_disparity"]),
                                   self.ext["trust_scale"])
            else:
                sw = self.ext["stereo_weight"]
                disp = sw * disp + (1.0 - sw) * guide
        return to_uint16(disp, p["num_disparities"], self.ext["normalize"])
