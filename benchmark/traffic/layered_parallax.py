"""Film-like side-by-side clips of layered-parallax scenes, rendered on the
device from a seed.

Each scene is a textured far plane whose disparity ramps from the top row to
the bottom (a ground plane), with a low-texture band of sky at the top, and
textured foreground slabs at nearer disparities that translate a few pixels
a frame; the first ``flat_slabs`` slabs are nearly flat colour, so the
matcher meets low-texture areas as well as occlusions at every slab edge.
The background pans. A clip cuts to a new scene every ``frames / scenes``
frames.

Disparities are in unsqueezed pixels (the width the matcher sees). A scene
is drawn in those coordinates: the left eye samples a layer at x, the right
eye at x + d, so a left pixel at x matches the right one at x - d. Half-SBS
squeezes each eye 2x by averaging column pairs (anamorphic); full-SBS keeps
the eyes at full width. Layout (sizes, positions, speeds, disparities) comes
from a host RNG; textures from a ``torch.Generator`` on the device. The
same seed on the same device gives the same clip; every seed gives the same
number of scenes and slabs, so the work per frame does not depend on it.

``render(params, seed, device)`` -> dict with ``frames`` (N, H, W_sbs, 3)
uint8 on ``device`` and, with ``with_disparity``, ``disparity`` (N, H, W)
float32, the left eye's true disparity in unsqueezed pixels.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _noise(g, c: int, h: int, w: int, cell: int, octaves: int,
           device) -> torch.Tensor:
    """(c, h, w) multi-scale value noise in [0, 1]: ``octaves`` grids of
    uniform values, the first at ``cell`` pixels a cell, each next at half
    the cell and 0.6 of the weight, upsampled bilinearly and summed."""
    out = torch.zeros((1, c, h, w), device=device)
    total = 0.0
    amp = 1.0
    for k in range(octaves):
        s = max(1, cell >> k)
        grid = torch.rand((1, c, h // s + 2, w // s + 2), generator=g,
                          device=device)
        up = F.interpolate(grid, scale_factor=s, mode="bilinear",
                           align_corners=False)
        out += amp * up[..., :h, :w]
        total += amp
        amp *= 0.6
    return (out / total)[0]


def _texture(g, rng, h: int, w: int, flat: bool, device) -> torch.Tensor:
    """(3, h, w) RGB in [0, 255]: a random base colour modulated by noise,
    or for ``flat`` a nearly uniform colour (about 1.5 levels of grain)."""
    base = torch.tensor(rng.uniform(40.0, 215.0, 3), dtype=torch.float32,
                        device=device).view(3, 1, 1)
    if flat:
        return base + 3.0 * (_noise(g, 1, h, w, 2, 1, device) - 0.5)
    lum = _noise(g, 1, h, w, int(rng.integers(24, 64)), 6, device)
    tint = _noise(g, 3, h, w, 64, 2, device)
    tex = base * (0.35 + 1.3 * lum) + 40.0 * (tint - 0.5)
    return tex.clamp(0.0, 255.0)


def _sample(tex: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """tex (3, R, T) sampled at fractional columns u (R, W) or (W,) by
    linear interpolation between the two nearest columns: (3, R, W)."""
    t = tex.shape[-1]
    u = u.clamp(0.0, t - 1.0)
    i0 = torch.floor(u).clamp(max=t - 2)
    frac = (u - i0).to(tex.dtype)
    i0 = i0.long()
    if u.dim() == 1:
        a = tex.index_select(-1, i0)
        b = tex.index_select(-1, i0 + 1)
    else:
        idx = i0.unsqueeze(0).expand(3, -1, -1)
        a = torch.gather(tex, -1, idx)
        b = torch.gather(tex, -1, idx + 1)
    return a + (b - a) * frac


def _scene(g, rng, p: dict, h: int, w: int, n_frames: int, device) -> dict:
    """One scene's textures and layout."""
    far_lo, far_hi = p["far_disparity"]
    pan = float(rng.uniform(-p["pan_px"], p["pan_px"]))
    margin = int(math.ceil(far_hi + abs(pan) * n_frames)) + 4
    bg = _texture(g, rng, h, w + 2 * margin, False, device)
    sky = int(p["sky_share"] * h)
    if sky:
        # low texture: the top rows fade to the mean colour
        fade = torch.linspace(0.0, 1.0, sky, device=device).view(1, sky, 1)
        mean = bg[:, :sky].mean(dim=(1, 2), keepdim=True)
        bg[:, :sky] = mean + (bg[:, :sky] - mean) * (0.05 + 0.95 * fade)
    d_top = float(rng.uniform(far_lo, (far_lo + far_hi) / 2))
    d_bot = float(rng.uniform((far_lo + far_hi) / 2, far_hi))
    slabs = []
    s_lo, s_hi = p["slab_disparity"]
    for k in range(p["slabs"]):
        ph = int(rng.integers(h // 5, h // 2))
        pw = int(rng.integers(max(8, w // 8), max(9, w // 3)))
        slabs.append(dict(
            tex=_texture(g, rng, ph, pw + 2, k < p["flat_slabs"], device),
            ph=ph, pw=pw,
            y0=float(rng.uniform(0, h - ph)), x0=float(rng.uniform(0, w - pw)),
            vy=float(rng.uniform(-p["slab_px"] / 2, p["slab_px"] / 2)),
            vx=float(rng.uniform(-p["slab_px"], p["slab_px"])),
            d=float(rng.uniform(s_lo, s_hi))))
    slabs.sort(key=lambda s: s["d"])  # nearer slabs paint last
    return dict(bg=bg, margin=margin, pan=pan, d_top=d_top, d_bot=d_bot,
                slabs=slabs)


def _paint(eye: torch.Tensor, disp, s: dict, t: int, d_eye: float, h: int,
           w: int) -> None:
    """Paint slab ``s`` at frame ``t`` into ``eye`` (3, h, w) in place,
    sampling its texture at x + d_eye - x0; with ``disp`` (h, w) also
    write the slab's disparity there."""
    ph, pw = s["ph"], s["pw"]
    span = max(h - ph, 1)
    y0 = int(round(s["y0"] + s["vy"] * t)) % span
    x0 = (s["x0"] + s["vx"] * t) % max(w - pw, 1)
    u = torch.arange(w, device=eye.device, dtype=torch.float32) + (d_eye - x0)
    inside = (u >= 0.0) & (u <= pw - 1.0)
    rows = slice(y0, y0 + ph)
    eye[:, rows] = torch.where(inside, _sample(s["tex"], u), eye[:, rows])
    if disp is not None:
        disp[rows] = torch.where(inside, s["d"], disp[rows])


def render(p: dict, seed: int, device, with_disparity: bool = False) -> dict:
    """The clip of traffic parameters ``p`` for ``seed`` (any whole
    number) on ``device``."""
    device = torch.device(device)
    h, w_sbs, n = p["height"], p["sbs_width"], p["frames"]
    half = p["format"] == "half_sbs"
    if p["format"] not in ("half_sbs", "full_sbs") or w_sbs % (4 if half
                                                               else 2):
        raise ValueError(f"bad SBS format or width: {p['format']}, {w_sbs}")
    w = w_sbs if half else w_sbs // 2  # unsqueezed eye width
    seed = int(seed) % 2**64  # any whole number, negative ones too
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    frames = torch.empty((n, h, w_sbs, 3), dtype=torch.uint8, device=device)
    disp_out = (torch.empty((n, h, w), dtype=torch.float32, device=device)
                if with_disparity else None)
    per_scene = -(-n // p["scenes"])
    xs = torch.arange(w, device=device, dtype=torch.float32)
    for f in range(n):
        t = f % per_scene
        if t == 0:
            sc = _scene(g, rng, p, h, w, per_scene, device)
            ramp = torch.linspace(sc["d_top"], sc["d_bot"], h, device=device)
        off = sc["margin"] + sc["pan"] * t
        eyes = []
        for d_sign in (0.0, 1.0):  # left, right
            u = xs.view(1, w) + off + d_sign * ramp.view(h, 1)
            eyes.append(_sample(sc["bg"], u))
        disp = ramp.view(h, 1).expand(h, w).clone() if with_disparity else None
        for s in sc["slabs"]:
            _paint(eyes[0], disp, s, t, 0.0, h, w)
            _paint(eyes[1], None, s, t, s["d"], h, w)
        if half:  # anamorphic squeeze: average column pairs
            eyes = [e.view(3, h, w // 2, 2).mean(-1) for e in eyes]
        sbs = torch.cat(eyes, dim=-1)
        frames[f] = sbs.round().clamp(0, 255).to(torch.uint8).permute(1, 2, 0)
        if with_disparity:
            disp_out[f] = disp
    out = dict(frames=frames)
    if with_disparity:
        out["disparity"] = disp_out
    return out
