"""Plain CREStereo-lite forward of the reference, from the weights file.

The network of the configuration's ``guide`` widths: a shared conv encoder
at 1/4 resolution for both eyes, a context encoder on the left eye (tanh
hidden, relu context), a correlation volume of max_disparity / 4 shifts of
the right features (first column replicated, -1e4 where x < d, scaled by
1/sqrt(C)), a pyramid pooling the disparity axis by 2 per level (an odd
level padded with its last bin), a first-maximum argmax start, ``iters``
ConvGRU updates with shared weights that read each level around the
current disparity with clipped linear taps, and the x4 bilinear upsample
clamped at 0. Eyes from 720 rows up run at 1/``infer_scale_hd``
(bilinear), the disparity scaled back and resized.

Precision follows the configuration's ``conv_dtype``, bfloat16: each
convolution casts its input, weight (kept float32) and bias to bfloat16
and returns bfloat16, so the encoders, the GRU and the head run in
bfloat16; the correlation sums bfloat16 products in float32, rounds the sum
to bfloat16 and scales it in float32; the pyramid, the lookups and the
disparity are float32. ``conv="fp8"`` (the control) first rounds each
convolution's input and weight per tensor to float8 e4m3, one step below.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.image import resize2d

FP8_MAX = 448.0  # largest finite float8 e4m3


def load(path) -> dict:
    """The weights file's tensors, float32."""
    from safetensors.torch import load_file

    return {k: v.to(torch.float32) for k, v in load_file(str(path)).items()}


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = FP8_MAX / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Net:
    """The forward of one weights dict on one device."""

    def __init__(self, weights: dict, guide: dict, device, conv: str):
        if conv not in ("bf16", "fp8") or guide["conv_dtype"] != "bfloat16":
            raise ValueError(f"unknown conv precision: {conv}, "
                             f"{guide['conv_dtype']}")
        self.w = {k: v.to(device) for k, v in weights.items()}
        self.g = guide
        self.conv_mode = conv

    def conv(self, x: torch.Tensor, name: str, stride: int = 1):
        wt, b = self.w[name + ".weight"], self.w[name + ".bias"]
        if self.conv_mode == "fp8":
            x, wt = _fp8(x.to(torch.float32)), _fp8(wt)
        bf = torch.bfloat16
        return F.conv2d(x.to(bf), wt.to(bf), b.to(bf), stride=stride,
                        padding=wt.shape[-1] // 2)

    def encoder(self, x: torch.Tensor, name: str) -> torch.Tensor:
        x = torch.relu(self.conv(x, f"{name}.conv1", 2))
        x = torch.relu(self.conv(x, f"{name}.conv2"))
        x = torch.relu(self.conv(x, f"{name}.conv3", 2))
        return self.conv(x, f"{name}.conv4")

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                image_mode: str = "f64"):
        """NHWC eyes in [0, 255] (float32) -> disparity (B, H, W); the
        final upsample resamples in ``image_mode``."""
        g = self.g
        x = torch.cat([left, right], dim=0) / 127.5 - 1.0
        fl, fr = self.encoder(x.permute(0, 3, 1, 2), "fnet").chunk(2, dim=0)
        ctx = self.encoder((left / 127.5 - 1.0).permute(0, 3, 1, 2), "cnet")
        hidden = torch.tanh(ctx[:, :g["hidden_dim"]])
        context = torch.relu(ctx[:, g["hidden_dim"]:])

        nd = max(2, g["max_disparity"] // 4)
        c, w = fl.shape[1], fl.shape[-1]
        scale = float(np.float32(1.0) / np.sqrt(np.float32(c)))
        xs = torch.arange(w, device=fl.device)
        vol = []
        for d in range(nd):
            fr_d = torch.cat([fr[..., :1].expand(*fr.shape[:-1], d),
                              fr[..., :w - d]], dim=-1) if d else fr
            corr = (fl * fr_d).float().sum(1).to(fl.dtype).float() * scale
            vol.append(torch.where(xs < d, -1e4, corr))
        pyramid = [torch.stack(vol, dim=-1)]
        for _ in range(g["corr_levels"] - 1):
            prev = pyramid[-1]
            if prev.shape[-1] % 2:
                prev = torch.cat([prev, prev[..., -1:]], dim=-1)
            pyramid.append(prev.unflatten(-1, (-1, 2)).mean(-1))

        disp = torch.argmax(pyramid[0], dim=-1).to(torch.float32)
        r = g["lookup_radius"]
        offsets = torch.arange(-r, r + 1, device=disp.device,
                               dtype=torch.float32)
        for _ in range(g["iters"]):
            taps = []
            for i, lv in enumerate(pyramid):
                n = lv.shape[-1]
                pos = (disp / 2 ** i).unsqueeze(-1) + offsets
                pos = pos.clamp(0.0, n - 1.0)
                lo = torch.floor(pos)
                frac = pos - lo
                lo = lo.long()
                hi = (lo + 1).clamp(max=n - 1)
                taps.append(torch.gather(lv, -1, lo) * (1.0 - frac)
                            + torch.gather(lv, -1, hi) * frac)
            motion = torch.cat(taps + [disp.unsqueeze(-1)], dim=-1)
            motion = torch.relu(self.conv(motion.permute(0, 3, 1, 2),
                                          "menc"))
            x = torch.cat([motion, context], dim=1)
            hx = torch.cat([hidden, x], dim=1)
            z = torch.sigmoid(self.conv(hx, "gru.convz"))
            rr = torch.sigmoid(self.conv(hx, "gru.convr"))
            q = torch.tanh(self.conv(torch.cat([rr * hidden, x], dim=1),
                                     "gru.convq"))
            hidden = (1.0 - z) * hidden + z * q
            disp = disp + self.conv(hidden, "head")[:, 0].float()
        h, w_full = left.shape[1], left.shape[2]
        return resize2d(disp, h, w_full, "bilinear",
                        image_mode).clamp(min=0.0) * 4.0

    def guidance(self, left: torch.Tensor, right: torch.Tensor,
                 image_mode: str) -> torch.Tensor:
        """RGB eyes (B, H, W, 3) -> disparity (B, H, W) in pixels."""
        h, w = left.shape[1], left.shape[2]
        s = self.g["infer_scale_hd"]
        s = s if h >= 720 and s > 1 else 1
        if s > 1:
            left, right = (resize2d(e.movedim(-1, 1), h // s, w // s,
                                    "bilinear", image_mode).movedim(1, -1)
                           for e in (left, right))
        with torch.no_grad():
            out = self.forward(left.to(torch.float32),
                               right.to(torch.float32), image_mode)
        if s > 1:
            out = resize2d(out * float(s), h, w, "bilinear", image_mode)
        return out.to(torch.float64)
