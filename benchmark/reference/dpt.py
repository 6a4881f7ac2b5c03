"""Plain DPT forward of the reference (HF ``DPTForDepthEstimation``,
``Intel/dpt-large``; Ranftl et al., arXiv:2103.13413), from HF-named
weights.

The network of the configuration's ``guide`` widths, as HF's modules
compute it:

- ViT: a ``patch_size`` convolution with stride ``patch_size``, the cls
  token, the learned position embeddings, pre-LN blocks (layer norm,
  softmax(q k^T / sqrt(head dim)) v over the heads, the output dense, the
  residual; layer norm, dense, exact (erf) GELU, dense, the residual);
- reassemble (readout ``project``): each tapped block's output (before the
  final layer norm), its patch tokens concatenated with the cls token,
  dense and GELU, put back on the patch grid, a 1x1 projection to the
  neck width, then a transposed convolution (factor > 1, kernel and stride
  the factor), nothing (1) or a 3x3 convolution with stride 1 / factor;
  a 3x3 convolution without bias to the fusion width;
- fusion, deepest stage first: the skip input through a pre-activation
  residual unit added (no skip in the deepest stage), another unit, an
  align-corners bilinear x2 upsample, a 1x1 projection;
- head: 3x3 to half the fusion width, align-corners x2, 3x3 to 32, ReLU,
  1x1 to 1, ReLU.

Departures from HF, none of which changes what is computed at the shapes
the guide runs at: the position embeddings are used as they are, so the
input must be the trained ``image_size`` square (HF resizes them to other
grids); a skip input whose shape differs from the upsampled path raises
(HF resizes it); the align-corners upsamples are products with the
interpolation matrices, float32 in, float32 out; dropout and head masks
are left out (inference); ``head_in_index`` is -1 and there is no
pre-head projection, as in ``Intel/dpt-large``.

Precision: ``mode="f32"`` computes everything in float32 with TF32 off,
the reference. ``mode="low"`` is the control, one step below what the
configuration states (bfloat16 backbone and neck, float32 decoder): the
ViT's and neck's products take operands rounded per tensor to float8 e4m3,
the decoder's convolutions run in bfloat16, and its upsamples take
operands rounded to TF32's mantissa.

Keyframes run in blocks of ``BLOCK``; the guide's own resizes (to the
inference square and back) are the reference's image resamples
(:func:`benchmark.reference.image.resize2d`) in float64.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.crestereo import _fp8
from benchmark.reference.depth import exact_float32
from benchmark.reference.image import resize2d, to_tf32

BLOCK = 4  # keyframes through the network at once
MEAN = STD = 0.5  # the Intel/dpt-large preprocessor's normalisation


def load(model_dir) -> dict:
    """The checkpoint directory's ``model.safetensors``, float32."""
    from safetensors.torch import load_file

    return {k: v.to(torch.float32) for k, v in
            load_file(str(Path(model_dir) / "model.safetensors")).items()}


def ac_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) float32 align-corners bilinear interpolation matrix:
    output i samples input i (n_in - 1) / (n_out - 1)."""
    mat = np.zeros((n_out, n_in), np.float64)
    if n_out == 1 or n_in == 1:
        mat[:, 0] = 1.0
        return torch.from_numpy(mat.astype(np.float32))
    src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = src - lo
    np.add.at(mat, (np.arange(n_out), lo), 1.0 - frac)
    np.add.at(mat, (np.arange(n_out), hi), frac)
    return torch.from_numpy(mat.astype(np.float32))


class Net:
    """The forward of one weights dict (HF names, float32) on one
    device."""

    stereo = False

    def __init__(self, weights: dict, guide: dict, device, mode: str):
        if mode not in ("f32", "low"):
            raise ValueError(f"unknown precision mode: {mode}")
        self.w = {k: v.to(device) for k, v in weights.items()}
        self.g = guide
        self.low = mode == "low"

    # -- products --------------------------------------------------------

    def _round(self, *xs):
        """Operands of a backbone or neck product: fp8 e4m3 per tensor in
        the control, as they are otherwise."""
        return tuple(_fp8(x) for x in xs) if self.low else xs

    def linear(self, x, name):
        x, w = self._round(x, self.w[name + ".weight"])
        return F.linear(x, w, self.w[name + ".bias"])

    def conv(self, x, name, stride=1, padding=0, decoder=False):
        w = self.w[name + ".weight"]
        b = self.w.get(name + ".bias")
        if decoder and self.low:
            bf = torch.bfloat16
            return F.conv2d(x.to(bf), w.to(bf), None if b is None
                            else b.to(bf), stride=stride,
                            padding=padding).float()
        if not decoder:
            x, w = self._round(x, w)
        return F.conv2d(x, w, b, stride=stride, padding=padding)

    def upsample2(self, x):
        """Align-corners bilinear x2 of (B, C, H, W)."""
        h, w = x.shape[-2:]
        mh = ac_matrix(h, 2 * h).to(x.device)
        mw = ac_matrix(w, 2 * w).to(x.device)
        if self.low:
            x, mh, mw = to_tf32(x), to_tf32(mh), to_tf32(mw)
        x = torch.matmul(mh, x)
        if self.low:
            x = to_tf32(x)
        return torch.matmul(x, mw.t())

    # -- network ---------------------------------------------------------

    def attention(self, x, pre):
        g = self.g
        b, t, d = x.shape
        n = g["num_attention_heads"]

        def heads(name):
            return self.linear(x, f"{pre}.attention.attention.{name}").view(
                b, t, n, d // n).transpose(1, 2)

        q, k, v = heads("query"), heads("key"), heads("value")
        q, k = self._round(q, k)
        scores = torch.matmul(q, k.transpose(-1, -2)) * (d // n) ** -0.5
        probs = torch.softmax(scores, dim=-1)
        probs, v = self._round(probs, v)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, d)
        return self.linear(ctx, f"{pre}.attention.output.dense")

    def layer_norm(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"],
                            self.w[name + ".bias"], self.g["layer_norm_eps"])

    def backbone(self, pixels):
        """NCHW pixels -> the tapped blocks' outputs (B, T, hidden)."""
        g = self.g
        emb = "dpt.embeddings"
        p = g["patch_size"]
        if pixels.shape[-2:] != (g["image_size"], g["image_size"]):
            raise ValueError("the reference runs at the trained image size "
                             "only")
        x = self.conv(pixels, f"{emb}.patch_embeddings.projection", p)
        x = x.flatten(2).transpose(1, 2)
        cls = self.w[f"{emb}.cls_token"].expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.w[f"{emb}.position_embeddings"]
        taps = []
        for i in range(g["num_hidden_layers"]):
            pre = f"dpt.encoder.layer.{i}"
            h = self.layer_norm(x, f"{pre}.layernorm_before")
            x = x + self.attention(h, pre)
            h = self.layer_norm(x, f"{pre}.layernorm_after")
            h = F.gelu(self.linear(h, f"{pre}.intermediate.dense"))
            x = x + self.linear(h, f"{pre}.output.dense")
            if i in g["backbone_out_indices"]:
                taps.append(x)
        return taps

    def neck(self, taps, grid):
        out = []
        rs = "neck.reassemble_stage"
        for i, t in enumerate(taps):
            tokens = t[:, 1:]
            merged = torch.cat([tokens, t[:, :1].expand_as(tokens)], dim=-1)
            tokens = F.gelu(self.linear(merged,
                                        f"{rs}.readout_projects.{i}.0"))
            fm = tokens.transpose(1, 2).reshape(t.shape[0], -1, grid, grid)
            fm = self.conv(fm, f"{rs}.layers.{i}.projection")
            fac = float(self.g["reassemble_factors"][i])
            name = f"{rs}.layers.{i}.resize"
            if fac > 1:
                x, w = self._round(fm, self.w[name + ".weight"])
                fm = F.conv_transpose2d(x, w, self.w[name + ".bias"],
                                        stride=int(fac))
            elif fac < 1:
                fm = self.conv(fm, name, stride=int(round(1 / fac)),
                               padding=1)
            out.append(self.conv(fm, f"neck.convs.{i}", padding=1))
        return out

    def residual(self, x, name):
        y = self.conv(F.relu(x), f"{name}.convolution1", padding=1,
                      decoder=True)
        y = self.conv(F.relu(y), f"{name}.convolution2", padding=1,
                      decoder=True)
        return x + y

    def decoder(self, feats):
        fs = "neck.fusion_stage.layers"
        x = None
        for j, skip in enumerate(feats[::-1]):
            if x is not None:
                if skip.shape != x.shape:
                    raise ValueError("a skip input's shape differs from the "
                                     "upsampled path's")
                x = x + self.residual(skip, f"{fs}.{j}.residual_layer1")
            else:
                x = skip
            x = self.residual(x, f"{fs}.{j}.residual_layer2")
            x = self.conv(self.upsample2(x), f"{fs}.{j}.projection",
                          decoder=True)
        x = self.conv(x, "head.head.0", padding=1, decoder=True)
        x = self.upsample2(x)
        x = F.relu(self.conv(x, "head.head.2", padding=1, decoder=True))
        x = F.relu(self.conv(x, "head.head.4", decoder=True))
        return x[:, 0]

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """Normalised NCHW pixels (float32) -> relative inverse depth
        (B, H, W), HF's ``predicted_depth``."""
        with exact_float32():
            taps = self.backbone(pixels.to(torch.float32))
            grid = self.g["image_size"] // self.g["patch_size"]
            return self.decoder(self.neck(taps, grid))

    def guidance(self, left: torch.Tensor, right: torch.Tensor,
                 image_mode: str) -> torch.Tensor:
        """The left eye's relative depth: RGB (B, H, W, 3) in [0, 255] ->
        (B, H, W) float64. /255, (x - 0.5) / 0.5, resized to the inference
        square, the network in blocks, resized back."""
        h, w = left.shape[1], left.shape[2]
        s = self.g["image_size"]
        x = (left.to(torch.float64) / 255.0 - MEAN) / STD
        x = resize2d(x.movedim(-1, 1), s, s, "bilinear", image_mode)
        with torch.no_grad():
            depth = torch.cat([self.forward(x[i:i + BLOCK])
                               for i in range(0, x.shape[0], BLOCK)])
        return resize2d(depth.to(torch.float64), h, w, "bilinear",
                        image_mode)
