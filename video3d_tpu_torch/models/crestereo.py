"""CREStereo-lite recurrent stereo matcher in PyTorch (inference).

Counterpart of :mod:`video3d_tpu.models.crestereo`, the backend of the
shipped hybrid default (``video-3d-depth`` with no flags):

* a shared conv encoder at 1/4 resolution for both eyes (``fnet``) and a
  context encoder on the left eye (``cnet``), NCHW;
* a 1-D correlation volume along the width from edge-replicated shifts,
  ``-1e4`` where x < d, scaled by 1/sqrt(C) (:func:`build_corr_volume`);
* a pyramid that pools the disparity axis by 2 per level, an argmax init
  (first maximum), then ``iters`` ConvGRU updates with shared weights,
  each reading the pyramid around the current disparity with clipped
  linear taps (:func:`lookup_corr`: one ``torch.gather`` for all taps
  selects the values the JAX one-hot contractions select);
* the x4 bilinear upsample, clamped at 0.

The public layout is the JAX package's: NHWC eyes in [0, 255] in,
(B, H, W) disparity in pixels out. Dtypes follow flax's ``nn.Conv(dtype=
cfg.dtype)``: the weights stay f32 and every conv casts its input, kernel
and bias to ``cfg.dtype`` and returns that dtype. With bf16 the encoders,
the GRU and the head run in bf16; the correlation sums bf16 products but
is f32 (the JAX scale is an f32 array), and the disparity and its deltas
are f32. On a CUDA device f32 convolutions follow
``torch.backends.cudnn.allow_tf32``.

Weights: :func:`jax_params_to_state_dict` carries the JAX checkpoint's
flax params across (HWIO kernels to OIHW); the bundled v1 checkpoint ships
converted as ``video3d_tpu_torch/weights/crestereo_v1.safetensors``
(:data:`BUNDLED_WEIGHTS`), which :func:`load_crestereo_guidance` reads.
Training (``sequence_loss``, ``train_step``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from video3d_tpu_torch.core.trace import span
from video3d_tpu_torch.models.guidance import GuidanceFn, loader_device
from video3d_tpu_torch.ops.image import resize2d

# the JAX package's bundled crestereo_ckpt/ (v1), converted
BUNDLED_WEIGHTS = (Path(__file__).resolve().parents[1] / "weights"
                   / "crestereo_v1.safetensors")


@dataclasses.dataclass(frozen=True)
class CREStereoConfig:
    feat_dim: int = 64
    hidden_dim: int = 64
    context_dim: int = 64
    max_disparity: int = 64  # full-resolution disparity range
    iters: int = 6
    lookup_radius: int = 4
    # compute dtype of the convs; the weights stay f32
    dtype: torch.dtype = torch.float32
    # levels of the pooled-disparity pyramid
    corr_levels: int = 3

    @classmethod
    def tiny(cls) -> "CREStereoConfig":
        return cls(feat_dim=16, hidden_dim=16, context_dim=16,
                   max_disparity=16, iters=3, lookup_radius=2,
                   corr_levels=2)


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv(dtype=...)``: input, kernel and bias cast to the
    compute dtype, output in it. ``k``: a side, or (height, width); the
    padding keeps the size at stride 1."""

    def __init__(self, cin: int, cout: int, k, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        pad = tuple(n // 2 for n in k) if isinstance(k, tuple) else k // 2
        super().__init__(cin, cout, k, stride=stride, padding=pad)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt))


class FeatureEncoder(nn.Module):
    """1/4-resolution conv encoder (shared between eyes), NCHW."""

    def __init__(self, out_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 32, 7, stride=2, dtype=dtype)
        self.conv2 = Conv2d(32, 48, 3, dtype=dtype)
        self.conv3 = Conv2d(48, 64, 3, stride=2, dtype=dtype)
        self.conv4 = Conv2d(64, out_dim, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        x = torch.relu(self.conv3(x))
        return self.conv4(x)


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int, input_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = Conv2d(cin, hidden_dim, 3, dtype=dtype)
        self.convr = Conv2d(cin, hidden_dim, 3, dtype=dtype)
        self.convq = Conv2d(cin, hidden_dim, 3, dtype=dtype)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1.0 - z) * h + z * q


def build_corr_volume(fl: torch.Tensor, fr: torch.Tensor,
                      num_disp: int) -> torch.Tensor:
    """corr[b, y, x, d] = <fl(x), fr(x - d)> / sqrt(C), (B, h, w, D) f32.

    ``fl``, ``fr`` are (B, C, h, w). ``fr`` is shifted with its first
    column replicated; out-of-frame entries (x < d) get -1e4. The product
    is in the features' dtype and summed in f32; a bf16 sum is rounded to
    bf16 before the f32 scale, as ``jnp.sum`` returns the input's dtype.
    """
    c, w = fl.shape[1], fl.shape[-1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(c)))
    xs = torch.arange(w, device=fl.device)
    slices = []
    for d in range(num_disp):
        if d == 0:
            fr_d = fr
        else:
            edge = fr[..., :1].expand(*fr.shape[:-1], d)
            fr_d = torch.cat([edge, fr[..., :-d]], dim=-1)
        corr = (fl * fr_d).float().sum(dim=1).to(fl.dtype).float() * scale
        slices.append(torch.where(xs < d, -1e4, corr))
    return torch.stack(slices, dim=-1)


def lookup_corr(corr: torch.Tensor, disp: torch.Tensor,
                radius: int) -> torch.Tensor:
    """Sample ``corr`` (B, h, w, D) at ``disp`` (B, h, w) + j for j in
    [-radius, radius], linearly interpolated between clipped integer taps:
    (B, h, w, 2 * radius + 1). All taps in one gather per neighbour."""
    nd = corr.shape[-1]
    offsets = torch.arange(-radius, radius + 1, device=disp.device,
                           dtype=disp.dtype)
    pos = torch.clamp(disp.unsqueeze(-1) + offsets, 0.0, nd - 1.0)
    lo = torch.floor(pos)
    frac = pos - lo
    lo_i = lo.long()
    hi_i = torch.clamp(lo_i + 1, max=nd - 1)
    return (torch.gather(corr, -1, lo_i) * (1.0 - frac)
            + torch.gather(corr, -1, hi_i) * frac)


class CREStereoLite(nn.Module):
    """Recurrent stereo matcher: (left, right) NHWC in [0, 255] ->
    disparity (B, H, W) in pixels."""

    def __init__(self, cfg: CREStereoConfig = CREStereoConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.fnet = FeatureEncoder(c.feat_dim, c.dtype)
        self.cnet = FeatureEncoder(c.hidden_dim + c.context_dim, c.dtype)
        n_lookup = c.corr_levels * (2 * c.lookup_radius + 1) + 1
        self.menc = Conv2d(n_lookup, c.context_dim, 3, dtype=c.dtype)
        self.gru = ConvGRU(c.hidden_dim, 2 * c.context_dim, c.dtype)
        self.head = Conv2d(c.hidden_dim, 1, 3, dtype=c.dtype)

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        """The encoders, the correlation, the GRU steps and the upsample
        are host-only ``guide.*`` spans (:mod:`video3d_tpu_torch.core.trace`:
        the forward's launches set its pace)."""
        c = self.cfg
        with span("guide.features"):
            x = torch.cat([left, right], dim=0) / 127.5 - 1.0
            fl, fr = self.fnet(x.permute(0, 3, 1, 2)).chunk(2, dim=0)
            ctx = self.cnet((left / 127.5 - 1.0).permute(0, 3, 1, 2))
            hidden = torch.tanh(ctx[:, :c.hidden_dim])
            context = torch.relu(ctx[:, c.hidden_dim:])

        with span("guide.corr"):
            corr = build_corr_volume(fl, fr, max(2, c.max_disparity // 4))
            pyramid = [corr]
            for _ in range(c.corr_levels - 1):
                prev = pyramid[-1]
                if prev.shape[-1] % 2:  # pad an odd level with its last bin
                    prev = torch.cat([prev, prev[..., -1:]], dim=-1)
                pyramid.append(prev.unflatten(-1, (-1, 2)).mean(-1))
            # winner-take-all init; argmax takes the first maximum
            disp = torch.argmax(corr, dim=-1).float()

        with span("guide.gru"):
            for _ in range(c.iters):
                lookups = [lookup_corr(lv, disp / float(2 ** i),
                                       c.lookup_radius)
                           for i, lv in enumerate(pyramid)]
                motion = torch.cat(lookups + [disp.unsqueeze(-1)], dim=-1)
                motion = torch.relu(self.menc(motion.permute(0, 3, 1, 2)))
                hidden = self.gru(hidden, torch.cat([motion, context], dim=1))
                disp = disp + self.head(hidden)[:, 0].float()

        with span("guide.resize_out"):
            h, w = left.shape[1], left.shape[2]
            return torch.clamp(resize2d(disp, h, w, method="bilinear") * 4.0,
                               min=0.0)


# ---------------------------------------------------------------------------
# Weights and the guidance entry point
# ---------------------------------------------------------------------------


def jax_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX checkpoint (``{'params': {'fnet'|'cnet'|'gru'|'menc'|'head':
    ...}}`` of numpy arrays, or the inner dict) as this module's
    ``state_dict``: ``a.b.kernel`` (HWIO) -> ``a.b.weight`` (OIHW),
    ``a.b.bias`` as it is, f32."""
    params = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, prefix + [k])
                continue
            a = np.array(v, dtype=np.float32)  # a writable copy
            if k == "kernel":
                k, a = "weight", np.ascontiguousarray(a.transpose(3, 2, 0, 1))
            out[".".join(prefix + [k])] = torch.from_numpy(a)

    walk(params, [])
    return out


def load_weights(path) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` from a ``.safetensors`` file (imports
    ``safetensors`` here, so the module imports without it)."""
    from safetensors.torch import load_file

    return load_file(str(path))


def load_crestereo_guidance(checkpoint=BUNDLED_WEIGHTS,
                            cfg: CREStereoConfig = CREStereoConfig(),
                            dtype: torch.dtype = torch.bfloat16,
                            infer_scale_hd: int = 2, device=None):
    """Stereo guidance fn for the depth stage: RGB eyes (B, H, W, 3) f32 in
    [0, 255] -> disparity (B, H, W) f32 in pixels.

    ``checkpoint`` is a ``.safetensors`` file of a ``state_dict`` (default:
    the bundled v1 weights); a missing file raises, and the stage then
    degrades to stereo-only. Its names pick the network: the published
    CREStereo's (``update_block.*``, ``self_att_fn.*``) build
    :class:`video3d_tpu_torch.models.crestereo_net.CREStereo` at the
    file's widths (:func:`published_guidance`; ``cfg`` is the lite's and
    is not read), any other this module's :class:`CREStereoLite` of
    ``cfg``. The convs run in ``dtype`` (weights stay f32). The lite: with
    H >= 720 the pair is resized bilinearly to 1/``infer_scale_hd``,
    matched, and the disparity scaled by ``infer_scale_hd`` and resized
    back. ``device`` defaults to ``cuda`` and raises without it.
    """
    device = loader_device(device, "load_crestereo_guidance")
    path = Path(checkpoint)
    if not path.is_file():
        raise FileNotFoundError(
            f"CREStereo weights not found: {checkpoint} (a .safetensors "
            f"file of CREStereoLite's or the published CREStereo's "
            f"state_dict)")
    state = load_weights(path)
    from video3d_tpu_torch.models import crestereo_net

    if crestereo_net.is_published(state):
        return published_guidance(state, dtype, infer_scale_hd, device)
    model = CREStereoLite(dataclasses.replace(cfg, dtype=dtype))
    model.load_state_dict(state)
    model = model.to(device).eval().requires_grad_(False)

    def apply_fn(module, left: torch.Tensor, right: torch.Tensor):
        h, w = left.shape[1], left.shape[2]
        s = infer_scale_hd if h >= 720 and infer_scale_hd > 1 else 1
        with torch.no_grad():
            if s == 1:
                return module(left, right)
            hs, ws = h // s, w // s
            with span("guide.resize_in"):
                ls, rs = (resize2d(e.movedim(-1, 1), hs, ws,
                                   method="bilinear").movedim(1, -1)
                          for e in (left, right))
            disp = module(ls, rs)
            with span("guide.resize_out"):
                return resize2d(disp * float(s), h, w, method="bilinear")

    return GuidanceFn(apply_fn, model, stereo=True)


def published_guidance(state: Mapping[str, torch.Tensor], dtype: torch.dtype,
                       infer_scale_hd: int, device) -> GuidanceFn:
    """The published CREStereo of ``state``'s widths as a stereo guidance
    fn: each keyframe pair resized bilinearly to its evaluation size
    (:func:`video3d_tpu_torch.models.crestereo_net.eval_shape`: 1080x1920
    -> 544x960 at ``infer_scale_hd`` 2), the two-pass inference, the
    disparity scaled by W / w_eval and resized back, as the published
    ``test.py`` does."""
    from video3d_tpu_torch.models.crestereo_net import (CREStereo,
                                                        PublishedConfig,
                                                        eval_shape)

    model = CREStereo(PublishedConfig.from_state_dict(state, dtype=dtype))
    model.load_state_dict(state)
    model = model.to(device).eval().requires_grad_(False)

    def apply_fn(module, left: torch.Tensor, right: torch.Tensor):
        h, w = left.shape[1], left.shape[2]
        he, we = eval_shape(h, w, infer_scale_hd)
        with torch.no_grad():
            with span("guide.resize_in"):
                ls, rs = (resize2d(e.movedim(-1, 1), he, we,
                                   method="bilinear") for e in (left, right))
            disp = module.infer(ls, rs)
            with span("guide.resize_out"):
                return resize2d(disp * (w / we), h, w, method="bilinear")

    return GuidanceFn(apply_fn, model, stereo=True)


def conv_flops(cfg: CREStereoConfig, h: int, w: int) -> int:
    """Multiply-add operations x 2 of one forward's convs on an (h, w)
    pair, counted from the shapes (the correlation and lookups are left
    out): the encoder on both eyes, the context encoder on the left, and
    ``iters`` times menc, the three GRU convs and the head at 1/4."""
    def out(n, s):  # conv output length, padding k // 2
        return n if s == 1 else (n - 1) // 2 + 1

    def enc(cout):
        h2, w2 = out(h, 2), out(w, 2)
        h4, w4 = out(h2, 2), out(w2, 2)
        return (h2 * w2 * 32 * 3 * 49 + h2 * w2 * 48 * 32 * 9
                + h4 * w4 * 64 * 48 * 9 + h4 * w4 * cout * 64 * 9), (h4, w4)

    f, (h4, w4) = enc(cfg.feat_dim)
    cx, _ = enc(cfg.hidden_dim + cfg.context_dim)
    n_lookup = cfg.corr_levels * (2 * cfg.lookup_radius + 1) + 1
    gru_in = cfg.hidden_dim + 2 * cfg.context_dim
    it = h4 * w4 * 9 * (n_lookup * cfg.context_dim + 3 * gru_in * cfg.hidden_dim
                        + cfg.hidden_dim)
    return 2 * (2 * f + cx + cfg.iters * it)
