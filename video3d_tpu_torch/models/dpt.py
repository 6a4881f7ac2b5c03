"""DPT (Dense Prediction Transformer) monocular depth in PyTorch.

Counterpart of :mod:`video3d_tpu.models.dpt`, the architecture of
HuggingFace ``DPTForDepthEstimation`` (``Intel/dpt-large``):

* ViT backbone (patch 16): patch-embed conv, cls token, learned position
  embeddings (bilinearly interpolated when the grid is not
  ``image_size / patch_size``), pre-LN blocks whose attention runs kernel
  B7 (:func:`video3d_tpu_torch.kernels.attention.attention_multihead`);
* reassemble neck: readout-projected tokens of four intermediate layers,
  re-gridded, resampled to strides {4, 8, 16, 32} (transposed convs x4,
  x2, a stride-2 conv at factor 0.5) and projected to the fusion width;
* feature-fusion decoder with pre-activation residual units and
  align-corners bilinear x2 upsampling; the depth head.

The public layout is the JAX package's: NHWC pixels in, (B, H, W) depth
out. Dtypes follow flax's promotion, as the JAX model computes: a layer
runs in the wider of its input's and its weights' dtypes. With bf16
weights the backbone and neck run in bf16, and every align-corners resize
(an f32 matmul) lifts what follows it to f32 -- the decoder and head, and
the whole backbone when the position embeddings are interpolated. On a
CUDA device those f32 convolutions follow
``torch.backends.cudnn.allow_tf32`` (PyTorch's default: TF32, the card's
counterpart of the TPU's default precision for f32 convolutions); with
TF32 off, cuDNN picks an FFT algorithm at batch 2 that costs ~120 ms per
keyframe on an H100 instead of ~14.

Weights: :func:`jax_params_to_state_dict` carries the JAX package's flax
params across, :func:`hf_state_dict_to_port` maps an HF state dict by name;
:func:`random_dpt_guidance` makes random weights from a seed (no
checkpoint ships with the repository).

Spans (:mod:`video3d_tpu_torch.core.trace`): ``guide.backbone`` (patch
embedding, position embeddings and the blocks; counts ``tokens``),
``guide.attention`` (each B7 call), ``guide.neck`` (readout, reassemble
and the neck's convs) and ``guide.decoder`` (the fusion stages and the
head) time the device; the guidance fn's ``guide.resize_in`` and
``guide.resize_out`` are host-only.
"""

from __future__ import annotations

import dataclasses
import json
from functools import lru_cache
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from video3d_tpu_torch.core.trace import span
from video3d_tpu_torch.kernels import attention as attention_kernels
from video3d_tpu_torch.models.guidance import loader_device as _loader_device

# DPT normalisation (Intel/dpt-large preprocessor: mean = std = 0.5).
DPT_MEAN = 0.5
DPT_STD = 0.5


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    """Subset of HF DPTConfig needed for depth estimation."""

    image_size: int = 384
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-12
    backbone_out_indices: Sequence[int] = (5, 11, 17, 23)
    neck_hidden_sizes: Sequence[int] = (256, 512, 1024, 1024)
    readout_type: str = "project"
    reassemble_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5)
    fusion_hidden_size: int = 256
    head_in_index: int = -1

    @classmethod
    def dpt_large(cls) -> "DPTConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "DPTConfig":
        """Small config for tests (matches an HF DPTConfig with same fields)."""
        return cls(
            image_size=64,
            patch_size=16,
            hidden_size=32,
            num_hidden_layers=4,
            num_attention_heads=2,
            intermediate_size=64,
            backbone_out_indices=(0, 1, 2, 3),
            neck_hidden_sizes=(16, 24, 32, 32),
            fusion_hidden_size=16,
        )

    @classmethod
    def from_hf(cls, hf: Mapping[str, Any]) -> "DPTConfig":
        """From an HF ``config.json`` dict, with the JAX loader's defaults."""
        d = cls()
        return cls(
            image_size=hf.get("image_size", d.image_size),
            patch_size=hf.get("patch_size", d.patch_size),
            num_channels=hf.get("num_channels", d.num_channels),
            hidden_size=hf.get("hidden_size", d.hidden_size),
            num_hidden_layers=hf.get("num_hidden_layers", d.num_hidden_layers),
            num_attention_heads=hf.get("num_attention_heads",
                                       d.num_attention_heads),
            intermediate_size=hf.get("intermediate_size", d.intermediate_size),
            layer_norm_eps=hf.get("layer_norm_eps", d.layer_norm_eps),
            backbone_out_indices=tuple(hf.get("backbone_out_indices",
                                              d.backbone_out_indices)),
            neck_hidden_sizes=tuple(hf.get("neck_hidden_sizes",
                                           d.neck_hidden_sizes)),
            readout_type=hf.get("readout_type", d.readout_type),
            fusion_hidden_size=hf.get("fusion_hidden_size",
                                      d.fusion_hidden_size),
        )


# ---------------------------------------------------------------------------
# align_corners=True bilinear resize (torch interpolate parity)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=128)
def _ac_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) align-corners bilinear interpolation matrix. A copy
    of the JAX package's matrix, pinned equal to it by test."""
    if n_in == 1:
        return np.ones((1, n_out), np.float32)
    if n_out == 1:
        m = np.zeros((n_in, 1), np.float32)
        m[0, 0] = 1.0
        return m
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.clip(lo + 1, 0, n_in - 1)
    frac = src - lo
    mat = np.zeros((n_in, n_out), np.float64)
    np.add.at(mat, (lo, np.arange(n_out)), 1.0 - frac)
    np.add.at(mat, (hi, np.arange(n_out)), frac)
    return mat.astype(np.float32)


@lru_cache(maxsize=128)
def _ac_matrix_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_ac_matrix(n_in, n_out)).to(device)


def _resize_ac_nchw(x: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """Align-corners bilinear resize of (B, C, H, W); f32 once resized."""
    h, w = x.shape[-2], x.shape[-1]
    if h != h_out:
        mh = _ac_matrix_on(h, h_out, x.device)
        x = torch.matmul(mh.t(), x.float())
    if w != w_out:
        mw = _ac_matrix_on(w, w_out, x.device)
        x = torch.matmul(x.float(), mw)
    return x


def resize_bilinear_ac(x: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """torch ``interpolate(mode='bilinear', align_corners=True)`` on NHWC,
    as f32 matmuls against :func:`_ac_matrix` (a resized tensor is f32,
    as the JAX einsum against the f32 matrix promotes it)."""
    return _resize_ac_nchw(x.permute(0, 3, 1, 2), h_out,
                           w_out).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Layers that compute in the promoted dtype of input and weights (flax)
# ---------------------------------------------------------------------------


def _promoted(x: torch.Tensor, weight: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, weight.dtype)


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype):
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promoted(x, self.weight)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promoted(x, self.weight)
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promoted(x, self.weight)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt), self.stride)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promoted(x, self.weight)
        return F.layer_norm(x.to(dt), self.normalized_shape,
                            self.weight.to(dt), self.bias.to(dt), self.eps)


# ---------------------------------------------------------------------------
# ViT backbone
# ---------------------------------------------------------------------------


class ViTSelfAttention(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.head_dim = h // cfg.num_attention_heads
        self.query = Linear(h, h)
        self.key = Linear(h, h)
        self.value = Linear(h, h)
        self.output = Linear(h, h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape

        def split(t):  # (B, S, H) -> (B, N, S, D)
            return t.reshape(b, s, self.num_heads,
                             self.head_dim).transpose(1, 2).contiguous()

        q, k, v = (split(lin(x)) for lin in (self.query, self.key,
                                             self.value))
        # kernel B7; heads_per_step is a TPU grouping and changes nothing
        # on the GPU, so the JAX default stands
        with span("guide.attention", q):
            out = attention_kernels.attention_multihead(
                q, k, v, sm_scale=1.0 / float(self.head_dim) ** 0.5)
        return self.output(out.transpose(1, 2).reshape(b, s, h))


class ViTBlock(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.layernorm_before = LayerNorm(h, eps=cfg.layer_norm_eps)
        self.attention = ViTSelfAttention(cfg)
        self.layernorm_after = LayerNorm(h, eps=cfg.layer_norm_eps)
        self.mlp_in = Linear(h, cfg.intermediate_size)
        self.mlp_out = Linear(cfg.intermediate_size, h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layernorm_before(x))
        h = F.gelu(self.mlp_in(self.layernorm_after(x)))  # exact (erf)
        return x + self.mlp_out(h)


class ViTBackbone(nn.Module):
    """Patch embed + cls token + position embeddings + blocks; returns the
    token sequences after the blocks at ``backbone_out_indices`` (HF
    semantics: before the final layer norm) and the patch grid."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        h, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = Conv2d(cfg.num_channels, h, p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, h))
        n_pos = (cfg.image_size // p) ** 2 + 1
        self.position_embeddings = nn.Parameter(torch.zeros(1, n_pos, h))
        self.layer = nn.ModuleList(
            [ViTBlock(cfg) for _ in range(cfg.num_hidden_layers)])

    def forward(self, pixels: torch.Tensor):
        b, hh, ww, _ = pixels.shape
        p = self.cfg.patch_size
        with span("guide.backbone", pixels,
                  tokens=b * ((hh // p) * (ww // p) + 1)):
            return self._forward(pixels)

    def _forward(self, pixels: torch.Tensor):
        c = self.cfg
        b, hh, ww, _ = pixels.shape
        gh, gw = hh // c.patch_size, ww // c.patch_size
        x = self.patch_embed(pixels.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # (B, gh*gw, hidden), row-major
        dt = torch.promote_types(x.dtype, self.cls_token.dtype)
        cls = self.cls_token.to(dt).expand(b, 1, c.hidden_size)
        x = torch.cat([cls, x.to(dt)], dim=1)
        pos = self.position_embeddings
        g0 = c.image_size // c.patch_size
        if (gh, gw) != (g0, g0):
            grid = pos[:, 1:].reshape(1, g0, g0, c.hidden_size)
            grid = resize_bilinear_ac(grid, gh, gw).reshape(
                1, gh * gw, c.hidden_size)
            pos = torch.cat([pos[:, :1].to(grid.dtype), grid], dim=1)
        x = x + pos
        taps: List[torch.Tensor] = []
        out_set = set(int(i) for i in c.backbone_out_indices)
        for i, block in enumerate(self.layer):
            x = block(x)
            if i in out_set:
                taps.append(x)
        return taps, (gh, gw)


# ---------------------------------------------------------------------------
# Neck: readout + reassemble + fusion, and the head
# ---------------------------------------------------------------------------


class PreActResidual(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        f = cfg.fusion_hidden_size
        self.conv1 = Conv2d(f, f, 3, padding=1)
        self.conv2 = Conv2d(f, f, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusion(nn.Module):
    """``has_skip`` False for the deepest stage, which has no skip input
    (and so no ``residual1``, as in the JAX model)."""

    def __init__(self, cfg: DPTConfig, has_skip: bool):
        super().__init__()
        f = cfg.fusion_hidden_size
        self.residual1 = PreActResidual(cfg) if has_skip else None
        self.residual2 = PreActResidual(cfg)
        self.projection = Conv2d(f, f, 1)

    def forward(self, x: torch.Tensor, skip=None) -> torch.Tensor:
        if skip is not None:
            if x.shape[-2:] != skip.shape[-2:]:
                skip = _resize_ac_nchw(skip, x.shape[-2], x.shape[-1])
            x = x + self.residual1(skip)
        x = self.residual2(x)
        x = _resize_ac_nchw(x, x.shape[-2] * 2, x.shape[-1] * 2)
        return self.projection(x)


class DPTDepthModel(nn.Module):
    """Full DPTForDepthEstimation forward: normalised NHWC pixels ->
    relative inverse depth (B, H, W) at the input resolution."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        h, f = cfg.hidden_size, cfg.fusion_hidden_size
        self.backbone = ViTBackbone(cfg)
        if cfg.readout_type == "project":
            self.readout = nn.ModuleList([Linear(2 * h, h) for _ in range(4)])
        else:
            self.readout = None
        sizes = [int(n) for n in cfg.neck_hidden_sizes]
        self.reassemble_proj = nn.ModuleList(
            [Conv2d(h, n, 1) for n in sizes])
        resize = []
        for n, fac in zip(sizes, cfg.reassemble_factors):
            fac = float(fac)
            if fac > 1.0:
                k = int(fac)
                resize.append(ConvTranspose2d(n, n, k, stride=k))
            elif fac < 1.0:
                s = int(round(1.0 / fac))
                resize.append(Conv2d(n, n, 3, stride=s, padding=1))
            else:
                resize.append(nn.Identity())
        self.reassemble_resize = nn.ModuleList(resize)
        self.neck_conv = nn.ModuleList(
            [Conv2d(n, f, 3, padding=1, bias=False) for n in sizes])
        # fusion[j] is the JAX model's fusion_j; fusion[3] runs first
        self.fusion = nn.ModuleList(
            [FeatureFusion(cfg, has_skip=j < 3) for j in range(4)])
        self.head_conv1 = Conv2d(f, f // 2, 3, padding=1)
        self.head_conv2 = Conv2d(f // 2, 32, 3, padding=1)
        self.head_conv3 = Conv2d(32, 1, 1)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        taps, (gh, gw) = self.backbone(pixels)
        b = pixels.shape[0]
        feats = []
        with span("guide.neck", pixels):
            for i, t in enumerate(taps):
                cls_tok, tokens = t[:, :1], t[:, 1:]
                if self.readout is not None:
                    merged = torch.cat([tokens, cls_tok.expand_as(tokens)],
                                       -1)
                    tokens = F.gelu(self.readout[i](merged))
                fm = tokens.reshape(b, gh, gw,
                                    c.hidden_size).permute(0, 3, 1, 2)
                fm = self.reassemble_resize[i](self.reassemble_proj[i](fm))
                feats.append(self.neck_conv[i](fm))
        with span("guide.decoder", pixels):
            x = self.fusion[3](feats[3])
            for j in (2, 1, 0):
                x = self.fusion[j](x, feats[j])
            x = self.head_conv1(x)
            x = _resize_ac_nchw(x, x.shape[-2] * 2, x.shape[-1] * 2)
            x = F.relu(self.head_conv2(x))
            x = F.relu(self.head_conv3(x))
            return x[:, 0]


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _skeleton(cfg: DPTConfig) -> DPTDepthModel:
    """The module tree without memory (names and shapes only)."""
    with torch.device("meta"):
        return DPTDepthModel(cfg)


def _flax_key(name: str) -> List[str]:
    """Port module path -> flax param path (``layer.3`` -> ``layer_3``)."""
    parts = name.split(".")
    out = []
    for p in parts:
        if p.isdigit():
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    return out


def jax_params_to_state_dict(params: Mapping[str, Any],
                             cfg: DPTConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's flax DPT params (``{"params": ...}``, leaves as
    numpy arrays) as this module's ``state_dict``.

    Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in); Conv HWIO ->
    OIHW; ConvTranspose: the flax kernel is the torch one with H and W
    flipped (``convert_torch_state_dict``), so flip back and move to
    (in, out, kh, kw); LayerNorm ``scale`` -> ``weight``; ``cls_token``
    and ``position_embeddings`` as they are.
    """
    tree = params["params"] if "params" in params else params

    def leaf(path):
        node = tree
        for p in path:
            node = node[p]
        return np.asarray(node, dtype=np.float32)

    sd: Dict[str, np.ndarray] = {}
    for name, mod in _skeleton(cfg).named_modules():
        path = _flax_key(name)
        if isinstance(mod, nn.Linear):
            sd[f"{name}.weight"] = leaf(path + ["kernel"]).T
        elif isinstance(mod, nn.ConvTranspose2d):
            k = leaf(path + ["kernel"])
            sd[f"{name}.weight"] = k[::-1, ::-1].transpose(2, 3, 0, 1)
        elif isinstance(mod, nn.Conv2d):
            k = leaf(path + ["kernel"])
            sd[f"{name}.weight"] = k.transpose(3, 2, 0, 1)
        elif isinstance(mod, nn.LayerNorm):
            sd[f"{name}.weight"] = leaf(path + ["scale"])
        else:
            continue
        if getattr(mod, "bias", None) is not None:
            sd[f"{name}.bias"] = leaf(path + ["bias"])
    for name in ("cls_token", "position_embeddings"):
        sd[f"backbone.{name}"] = leaf(["backbone", name])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def _hf_prefix(name: str) -> str:
    """Port module path -> HF ``DPTForDepthEstimation`` module path (the
    names of the JAX ``convert_torch_state_dict``)."""
    p = name.split(".")
    if p[0] == "backbone":
        if p[1] == "patch_embed":
            return "dpt.embeddings.patch_embeddings.projection"
        if p[1] in ("cls_token", "position_embeddings"):
            return f"dpt.embeddings.{p[1]}"
        layer = f"dpt.encoder.layer.{p[2]}"
        sub = p[3]
        if sub == "attention":
            if p[4] == "output":
                return f"{layer}.attention.output.dense"
            return f"{layer}.attention.attention.{p[4]}"
        return {"mlp_in": f"{layer}.intermediate.dense",
                "mlp_out": f"{layer}.output.dense"}.get(sub, f"{layer}.{sub}")
    if p[0] == "readout":
        return f"neck.reassemble_stage.readout_projects.{p[1]}.0"
    if p[0] == "reassemble_proj":
        return f"neck.reassemble_stage.layers.{p[1]}.projection"
    if p[0] == "reassemble_resize":
        return f"neck.reassemble_stage.layers.{p[1]}.resize"
    if p[0] == "neck_conv":
        return f"neck.convs.{p[1]}"
    if p[0] == "fusion":
        layer = f"neck.fusion_stage.layers.{3 - int(p[1])}"
        if p[2] == "projection":
            return f"{layer}.projection"
        res = {"residual1": "residual_layer1",
               "residual2": "residual_layer2"}[p[2]]
        conv = {"conv1": "convolution1", "conv2": "convolution2"}[p[3]]
        return f"{layer}.{res}.{conv}"
    return {"head_conv1": "head.head.0", "head_conv2": "head.head.2",
            "head_conv3": "head.head.4"}[p[0]]


def hf_state_dict_to_port(sd: Mapping[str, Any],
                          cfg: DPTConfig) -> Dict[str, torch.Tensor]:
    """An HF ``DPTForDepthEstimation`` state dict (torch tensors or numpy)
    as this module's ``state_dict``, by name; the layouts are torch's on
    both sides. HF entries the forward does not use (the final layer norm,
    the deepest fusion stage's skip residual) are left out."""
    out: Dict[str, torch.Tensor] = {}
    for key in _skeleton(cfg).state_dict():
        if key in ("backbone.cls_token", "backbone.position_embeddings"):
            src = _hf_prefix(key)
        else:
            mod, _, leaf = key.rpartition(".")
            src = f"{_hf_prefix(mod)}.{leaf}"
        t = sd[src]
        t = t if isinstance(t, torch.Tensor) else torch.from_numpy(
            np.asarray(t))
        out[key] = t.float()
    return out


# ---------------------------------------------------------------------------
# Guidance entry points
# ---------------------------------------------------------------------------


def make_guidance_fn(model: DPTDepthModel, infer_size: int = 384):
    """Wrap ``model`` as the depth stage's guidance fn: RGB (B, H, W, 3) f32
    in [0, 255] -> relative depth (B, H, W) f32.

    /255, (x - 0.5) / 0.5, bilinear resize to ``infer_size`` squared, the
    forward in the model's dtype (its weights' dtype), f32, bilinear
    resize back to (H, W). The model is put in eval mode without
    gradients.
    """
    from video3d_tpu_torch.models.guidance import GuidanceFn
    from video3d_tpu_torch.ops.image import resize2d

    model.eval().requires_grad_(False)
    dtype = next(model.parameters()).dtype

    def apply_fn(module, left_rgb: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = left_rgb.shape
        with span("guide.resize_in"):
            x = left_rgb / 255.0
            x = (x - DPT_MEAN) / DPT_STD
            x = resize2d(x.movedim(-1, 1), infer_size, infer_size,
                         method="bilinear").movedim(1, -1)
        with torch.no_grad():
            depth = module(x.to(dtype)).float()
        with span("guide.resize_out"):
            return resize2d(depth, h, w, method="bilinear")

    return GuidanceFn(apply_fn, model)


def random_dpt_guidance(cfg: Optional[DPTConfig] = None, seed: int = 0,
                        dtype: torch.dtype = torch.bfloat16,
                        infer_size: int = 384, device=None):
    """Guidance fn with random weights from ``seed`` (for benchmarks and
    load tests without a checkpoint: throughput and memory do not depend
    on the weights). Not a substitute for real weights in quality.

    The weights are drawn on ``device`` from a ``torch.Generator``:
    normal(0, 1/sqrt(fan_in)) for dense and conv kernels, zero biases,
    unit layer-norm scales, a zero cls token and normal(0, 0.02) position
    embeddings -- the scheme of flax's init, but not its values, which come
    from another generator (and differ between CPU and CUDA). ``device``
    defaults to ``cuda``.
    """
    device = _loader_device(device, "random_dpt_guidance")
    cfg = cfg or DPTConfig.dpt_large()
    model = _skeleton(cfg).to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = w[0].numel() if not isinstance(
                    mod, nn.ConvTranspose2d) else w.shape[0] * w[0, 0].numel()
                w.normal_(0.0, fan_in ** -0.5, generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        model.backbone.cls_token.zero_()
        model.backbone.position_embeddings.normal_(0.0, 0.02, generator=gen)
    return make_guidance_fn(model.to(dtype), infer_size=infer_size)


def load_dpt_safetensors(model_dir: str, dtype: torch.dtype = torch.bfloat16,
                         infer_size: int = 384, device=None):
    """DPT guidance from a local HF checkpoint directory (``config.json`` +
    ``*.safetensors``); weight names are HF ``DPTForDepthEstimation``'s.
    Needs the ``safetensors`` package (imported here, so the module
    imports without it). ``device`` defaults to ``cuda``."""
    from safetensors.torch import load_file

    device = _loader_device(device, "load_dpt_safetensors")

    d = Path(model_dir)
    cfg = DPTConfig.from_hf(json.loads((d / "config.json").read_text()))
    files = sorted(d.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(load_file(str(f)))
    return _guidance_from_hf(sd, cfg, dtype, infer_size, device)


def _guidance_from_hf(sd, cfg, dtype, infer_size, device):
    # the skeleton takes the loaded tensors (no random init of the
    # network's parameters on the host first)
    model = _skeleton(cfg)
    model.load_state_dict(hf_state_dict_to_port(sd, cfg), assign=True)
    model = model.to(device=_loader_device(device, "DPT guidance"),
                     dtype=dtype)
    return make_guidance_fn(model, infer_size=infer_size)


def load_dpt_guidance(checkpoint: str = "Intel/dpt-large",
                      dtype: torch.dtype = torch.bfloat16,
                      infer_size: int = 384, device=None):
    """DPT guidance from a local checkpoint: a directory holding
    ``*.safetensors`` goes to :func:`load_dpt_safetensors`, anything else
    to ``transformers`` with ``local_files_only``. Raises when neither can
    load it; the depth stage then falls back to stereo-only. ``device``
    defaults to ``cuda``."""
    device = _loader_device(device, "load_dpt_guidance")
    p = Path(checkpoint)
    if p.is_dir() and any(p.glob("*.safetensors")):
        return load_dpt_safetensors(checkpoint, dtype=dtype,
                                    infer_size=infer_size, device=device)
    import transformers

    tm = transformers.DPTForDepthEstimation.from_pretrained(
        checkpoint, local_files_only=True)
    cfg = DPTConfig.from_hf(tm.config.to_dict())
    return _guidance_from_hf(tm.state_dict(), cfg, dtype, infer_size, device)
