"""The reference depth step: a batch of SBS frames -> uint16 depth maps, by
the configuration's semantics, independent of the program.

Per frame: split the eyes, unsqueeze a half-SBS eye 2x (Lanczos-4), BT.601
gray, the matcher (:mod:`benchmark.reference.matcher`), with guidance the
background-extension hole fill, the keyframe guide (every
``guidance_every``-th frame of the batch serves itself and the frames after
it), a monocular guide's output landed in disparity units
(:func:`land_mono`), and the blend, then fixed-range or per-frame uint16.
Floating steps run in float64 except the guide's network, which runs in
the precision the configuration states; the guide's kind builds it
(``benchmark/guides/<kind>.py reference``). ``control=True`` computes every
configured float step of the image ops one precision lower (TF32
resampling, bfloat16 gray), and the caller passes the guide's network
built one precision lower too.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference import image, matcher
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


def ssi_fit(pred, target, weight):
    """Per-image weighted least-squares scale and shift of ``pred`` onto
    ``target`` (B, H, W); (B, 1, 1) each. A degenerate fit (|det| <= 1e-6)
    gives s = 1."""
    dims = (-2, -1)
    n = weight.sum(dim=dims).clamp(min=1.0)
    sp = (pred * weight).sum(dim=dims)
    st = (target * weight).sum(dim=dims)
    spp = (pred * pred * weight).sum(dim=dims)
    spt = (pred * target * weight).sum(dim=dims)
    det = n * spp - sp * sp
    s = torch.where(det.abs() > 1e-6, (n * spt - sp * st) / det, 1.0)
    t = (st - s * sp) / n
    return s[:, None, None], t[:, None, None]


def land_mono(mono, disp, conf, num_disparities: int,
              min_disparity: float, confidence: bool):
    """A monocular guide's relative depth (B, H, W) in disparity units:
    each image min-max normalised to [0, D]; with the confidence blend,
    where the scale-and-shift fit onto the confident stereo (weights: the
    confidence where disp > min_disparity - 0.5; target: disp clamped at
    0) has s > 0, the fitted guide clamped to [0, D] instead."""
    d = float(num_disparities)
    lo = mono.amin(dim=(-2, -1), keepdim=True)
    hi = mono.amax(dim=(-2, -1), keepdim=True)
    guide = (mono - lo) / (hi - lo).clamp(min=1e-6) * d
    if confidence:
        w = torch.where(disp > min_disparity - 0.5, conf, 0.0)
        s, t = ssi_fit(mono, disp.clamp(min=0.0), w)
        guide = torch.where(s > 0.0, (mono * s + t).clamp(0.0, d), guide)
    return guide


def blend(disp, conf, guide, stereo: bool, ext: dict, sgbm: dict):
    """The stereo disparity (after any fill) mixed with the guide's output
    for the same frames: ``conf`` is the matcher's confidence (the
    confidence blend), ``stereo`` whether the guide gives disparity."""
    confidence = ext["blend"] == "confidence"
    if not stereo:
        guide = land_mono(guide, disp, conf, sgbm["num_disparities"],
                          float(sgbm["min_disparity"]), confidence)
    if confidence:
        return trust_blend(disp, conf, guide, float(sgbm["min_disparity"]),
                           ext["trust_scale"])
    sw = ext["stereo_weight"]
    return sw * disp + (1.0 - sw) * guide


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
    ``net`` is the guide's plain forward (an object with ``stereo`` and
    ``guidance(left, right, image_mode)``), or None without a guide."""

    def __init__(self, config: dict, traffic: dict, net, device,
                 control: bool = False):
        self.ext = dict(config["extractor"], **traffic["options"])
        self.sgbm = config["sgbm"]
        self.unsqueeze = traffic["format"] == "half_sbs"
        self.every = int(self.ext["guidance_every"])
        self.device = torch.device(device)
        self.image_mode = "low" if control else "f64"
        if (net is None) != (config["guide"] is None):
            raise ValueError("a guide's reference network is given exactly "
                             "where the configuration has a guide")
        self.net = net

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
        margin = guide is not None and self.ext["blend"] == "confidence"
        res = matcher.disparity(gl, gr, p, want_confidence=margin,
                                apply_speckle=self.ext["apply_speckle"])
        disp, conf = res if margin else (res, None)
        if self.ext["fill_holes"]:
            disp = fill_holes(disp, float(p["min_disparity"] - 1))
        if guide is not None:
            disp = blend(disp, conf, guide, self.net.stereo, self.ext, p)
        return to_uint16(disp, p["num_disparities"], self.ext["normalize"])
