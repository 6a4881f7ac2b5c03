"""The published CREStereo (Li et al., "Practical Stereo Matching via
Cascaded Recurrent Network with Adaptive Correlation", CVPR 2022,
arXiv:2203.11483; code and weights: github.com/megvii-research/CREStereo)
in PyTorch, NCHW, inference only.

* ``fnet``: the RAFT-style residual encoder with parameter-free instance
  norm (conv 7x7/2 to 64, two blocks at 64, 96/2 and 128, a 1x1 conv to
  256), run on both eyes at once; its 1/4-resolution map of the left eye,
  split 128/128, also gives the GRU's hidden state (tanh) and context
  (ReLU);
* a 1/8 and 1/16 pyramid by average pooling, with learned search offsets
  (``conv_offset_8/16``: 3x3 conv to 9 (x, y) pairs, sigmoid, bounded to
  +-1 px);
* at 1/16, LoFTR's sine position encoding and linear-attention
  transformers (``self_att_fn``: a self layer, then a cross layer;
  ``cross_att_fn``: one more cross layer, which the published AGCL applies
  at every 1/16 call);
* adaptive group correlation (AGCL, :func:`agcl_deformable`,
  :func:`agcl_warped`): 4 groups x 9 search points, alternating a 1x9 and
  a 3x3 pattern step by step; at 1/16 and 1/8 the points move by the
  offsets and are read by bilinear sampling, at 1/4 the right map is
  warped once by the flow and shifted with replicate padding;
* the ``update_block``: motion encoder, SepConvGRU (1x5 then 5x1), flow
  head and convex-upsampling mask;
* the 1/16 -> 1/8 -> 1/4 cascade, and the published ``test.py``'s two
  passes (:meth:`CREStereo.infer`): the pair at half size without
  ``flow_init``, then the full pair seeded with the first pass.

Precision: the convolutions and the transformer's linears run in the
config's ``dtype`` (bf16 from the loader) on f32 weights cast to it, as
:class:`video3d_tpu_torch.models.crestereo.Conv2d` does (here each conv
keeps its cast kernel, channels-last, between calls); the instance- and
layer-norm statistics, the linear-attention sums, the GRU's state and
gates' blend, the flow, the sampling coordinates and the correlation are
f32.

On a CUDA device each refinement step's AGCL call is one launch of kernel
A1 (:mod:`video3d_tpu_torch.kernels.agcl`, ``csrc/agcl.cu``; the two AGCL
functions here are its plain twin and run on the CPU), and its update a
replay of a CUDA graph (:class:`StepGraphs`), captured per shape on first
use: eager, the 60 steps' ~6,000 launches a call made the host, not the
card, pace the stage. A1 writes the correlation channels-last into the
update graph's input. The update block's activations are channels-last,
the layout of cuDNN's bf16 kernels, so no conv transposes its input or
output.

Choices (points the published code or the paper leaves open, or where the
port departs from the published code without changing what it computes):

1. The hand-over between cascade levels negates the flow, as the published
   code does (``flow_dw8 = -scale * interpolate(flow)``; the same to 1/4
   and from ``flow_init``), so trained weights see what they were trained
   on.
2. Bilinear sampling takes pixel coordinates, zero outside the frame, the
   published ``bilinear_sampler``'s semantics (align-corners grid); it is
   written with ``grid_sample(align_corners=False)`` and the half-pixel
   mapping (2x + 1) / n - 1, which gives the same taps and is defined for a
   map one pixel high or wide.
3. ``cross_att_fn`` gets the same inputs at every 1/16 AGCL call, so it
   runs once a forward, before the 1/16 steps.
4. Only the last step of a cascade level is upsampled, so only it computes
   the mask head (128 -> 256 -> 144): the published steps' other masks feed
   the training losses alone.
5. The second pass (with ``flow_init``) computes neither the 1/8 and 1/16
   maps, offsets and context nor the transformer: the published forward
   computes them and never reads them there.
6. The keyframes of a call run as one batch; each sample's correlation is
   its own (the published AGCL's ``reshape(1, ...)`` takes one pair).
7. Sine position encoding: LoFTR's corrected form (``temp_bug_fix``),
   omega_k = exp(-2k ln(10000) / (d_model / 2)), x and y counted from 1.

Traced spans (:mod:`video3d_tpu_torch.core.trace`, with device events on
the eyes' stream): ``guide.encoder`` (``fnet`` on both eyes, each pass;
counts ``images``), ``guide.transformer`` (both transformers, first pass),
``guide.refine`` (each pass's cascade of update steps; counts ``steps``:
40 and 20 at ``iters`` 20) and, inside it, ``guide.agcl`` (each AGCL call;
counts ``deformable``: 1 at 1/16 and 1/8, 0 at 1/4; ``fused``: 1 where A1
ran, 0 on the CPU).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from video3d_tpu_torch.core.trace import span
from video3d_tpu_torch.kernels import agcl
from video3d_tpu_torch.models import crestereo

# the evaluation size's multiple: the half-size pass reaches 1/16
MULTIPLE = 32
# names only the published network's state_dict has
PUBLISHED_KEYS = ("update_block.", "self_att_fn.")


@dataclasses.dataclass(frozen=True)
class PublishedConfig:
    """Widths of the published CREStereo (its ``nets/`` defaults)."""
    encoder_dims: Tuple[int, int, int] = (64, 96, 128)
    feat_dim: int = 256  # fnet's output; split into hidden and context
    hidden_dim: int = 128
    context_dim: int = 128
    corr_dims: Tuple[int, int] = (256, 192)  # motion encoder, correlation
    flow_dims: Tuple[int, int] = (128, 64)  # motion encoder, flow
    motion_dim: int = 128  # the motion features with the flow's 2
    head_dim: int = 256  # flow head and mask head hidden width
    search_num: int = 9
    groups: int = 4
    mask_rate: int = 4
    d_model: int = 256
    nhead: int = 8
    iters: int = 20
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if (self.hidden_dim + self.context_dim != self.feat_dim
                or self.d_model != self.feat_dim
                or self.feat_dim % (self.groups * self.nhead)
                or self.search_num != 9 or self.iters % 2):
            raise ValueError(f"inconsistent CREStereo widths: {self}")

    @classmethod
    def tiny(cls, **kw) -> "PublishedConfig":
        """Every mechanism at small widths (the CPU tests)."""
        return cls(**dict(dict(
            encoder_dims=(8, 12, 16), feat_dim=32, hidden_dim=16,
            context_dim=16, corr_dims=(24, 16), flow_dims=(12, 8),
            motion_dim=16, head_dim=24, d_model=32), **kw))

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, torch.Tensor],
                        **kw) -> "PublishedConfig":
        """The widths a published ``state_dict`` holds (``nhead`` and
        ``iters`` are not in its shapes: the published 8 and 20, or
        ``kw``)."""
        def out(name):
            return int(sd[name + ".weight"].shape[0])

        u = "update_block."
        feat, hidden = out("fnet.conv2"), out(u + "gru.convz1")
        search = out("conv_offset_16") // 2
        mask = out(u + "mask.2") // 9
        return cls(**dict(dict(
            encoder_dims=tuple(out(f"fnet.layer{i}.0.conv1")
                               for i in (1, 2, 3)),
            feat_dim=feat, hidden_dim=hidden, context_dim=feat - hidden,
            corr_dims=(out(u + "encoder.convc1"), out(u + "encoder.convc2")),
            flow_dims=(out(u + "encoder.convf1"), out(u + "encoder.convf2")),
            motion_dim=out(u + "encoder.conv") + 2,
            head_dim=out(u + "flow_head.conv1"), search_num=search,
            groups=int(sd[u + "encoder.convc1.weight"].shape[1]) // search,
            mask_rate=int(round(math.sqrt(mask))),
            d_model=int(sd["self_att_fn.layers.0.q_proj.weight"].shape[1])),
            **kw))


def is_published(sd: Mapping[str, torch.Tensor]) -> bool:
    """Whether a ``state_dict``'s names are the published network's."""
    return all(any(k.startswith(p) for k in sd) for p in PUBLISHED_KEYS)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


CHANNELS_LAST = torch.channels_last


class Conv2d(crestereo.Conv2d):
    """The lite's dtype-casting conv whose kernel and bias, cast to the
    compute dtype, are kept between calls: the kernel channels-last, the
    layout cuDNN's bf16 kernels read, so its outputs are channels-last
    too. They are made again where the f32 weights move or change."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        key = (self.weight.data_ptr(), self.weight._version,
               self.bias._version)
        if getattr(self, "_key", None) != key:
            dt = self.compute_dtype
            self._cast = (self.weight.to(dt).contiguous(
                memory_format=CHANNELS_LAST), self.bias.to(dt))
            self._key = key
        w, b = self._cast
        return self._conv_forward(x.to(w.dtype), w, b)


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Instance norm without affine parameters, statistics in f32."""
    return F.instance_norm(x.float(), eps=1e-5)


class InstanceNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


class Linear(nn.Linear):
    """A linear without bias whose input and weight are cast to the compute
    dtype; output in it."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__(cin, cout, bias=False)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt))


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, dtype):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride=stride, dtype=dtype)
        self.conv2 = Conv2d(cout, cout, 3, dtype=dtype)
        self.downsample = (None if stride == 1 and cin == cout else
                           nn.Sequential(Conv2d(cin, cout, 1, stride=stride,
                                                dtype=dtype),
                                         InstanceNorm()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(instance_norm(self.conv1(x)))
        y = torch.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, cfg: PublishedConfig):
        super().__init__()
        d1, d2, d3 = cfg.encoder_dims
        dt = cfg.dtype
        self.conv1 = Conv2d(3, d1, 7, stride=2, dtype=dt)
        cin = d1
        for i, (d, s) in enumerate(((d1, 1), (d2, 2), (d3, 1)), 1):
            setattr(self, f"layer{i}", nn.Sequential(
                ResidualBlock(cin, d, s, dt), ResidualBlock(d, d, 1, dt)))
            cin = d
        self.conv2 = Conv2d(d3, cfg.feat_dim, 1, dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(instance_norm(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x).float()


class LoFTRLayer(nn.Module):
    """A LoFTR encoder layer with linear attention (elu + 1 maps)."""

    def __init__(self, d: int, nhead: int, dtype):
        super().__init__()
        self.nhead = nhead
        self.q_proj = Linear(d, d, dtype)
        self.k_proj = Linear(d, d, dtype)
        self.v_proj = Linear(d, d, dtype)
        self.merge = Linear(d, d, dtype)
        self.mlp = nn.Sequential(Linear(2 * d, 2 * d, dtype), nn.ReLU(),
                                 Linear(2 * d, d, dtype))
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)

    def _norm(self, x, ln):
        return F.layer_norm(x.float(), ln.normalized_shape, ln.weight,
                            ln.bias, ln.eps)

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        n, length, d = x.shape
        h = self.nhead
        q = F.elu(self.q_proj(x).float().view(n, length, h, -1)) + 1.0
        k = F.elu(self.k_proj(source).float().view(n, -1, h, d // h)) + 1.0
        v = self.v_proj(source).float().view(n, -1, h, d // h)
        s = v.shape[1]
        kv = torch.einsum("nshd,nshv->nhdv", k, v / s)
        z = 1.0 / (torch.einsum("nlhd,nhd->nlh", q, k.sum(dim=1)) + 1e-6)
        msg = torch.einsum("nlhd,nhdv,nlh->nlhv", q, kv, z) * s
        msg = self._norm(self.merge(msg.reshape(n, length, d)), self.norm1)
        msg = self._norm(self.mlp(torch.cat([x, msg], dim=-1)), self.norm2)
        return x + msg


class FeatureTransformer(nn.Module):
    """LoFTR's ``LocalFeatureTransformer``: self layers update each map,
    cross layers the first map against the second, then the second
    against the new first."""

    def __init__(self, d: int, nhead: int, names, dtype):
        super().__init__()
        self.names = tuple(names)
        self.layers = nn.ModuleList(LoFTRLayer(d, nhead, dtype)
                                    for _ in self.names)

    def forward(self, f0: torch.Tensor, f1: torch.Tensor):
        for layer, name in zip(self.layers, self.names):
            if name == "self":
                f0, f1 = layer(f0, f0), layer(f1, f1)
            else:
                f0 = layer(f0, f1)
                f1 = layer(f1, f0)
        return f0, f1


class MotionEncoder(nn.Module):
    def __init__(self, cfg: PublishedConfig):
        super().__init__()
        dt = cfg.dtype
        c1, c2 = cfg.corr_dims
        f1, f2 = cfg.flow_dims
        self.convc1 = Conv2d(cfg.groups * cfg.search_num, c1, 1, dtype=dt)
        self.convc2 = Conv2d(c1, c2, 3, dtype=dt)
        self.convf1 = Conv2d(2, f1, 7, dtype=dt)
        self.convf2 = Conv2d(f1, f2, 3, dtype=dt)
        self.conv = Conv2d(c2 + f2, cfg.motion_dim - 2, 3, dtype=dt)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        flow = flow.to(out.dtype, memory_format=CHANNELS_LAST)
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden: int, cin: int, dtype):
        super().__init__()
        c = hidden + cin
        for i, k in ((1, (1, 5)), (2, (5, 1))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{i}", Conv2d(c, hidden, k,
                                                       dtype=dtype))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``h`` f32, ``x`` in the compute dtype; the new ``h`` in f32."""
        for i in (1, 2):
            hx = torch.cat([h.to(x.dtype), x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{i}")(hx)).float()
            r = torch.sigmoid(getattr(self, f"convr{i}")(hx)).float()
            q = torch.tanh(getattr(self, f"convq{i}")(
                torch.cat([(r * h).to(x.dtype), x], dim=1))).float()
            h = torch.lerp(h, q, z)  # (1 - z) h + z q
        return h


class FlowHead(nn.Module):
    def __init__(self, cin: int, hidden: int, dtype):
        super().__init__()
        self.conv1 = Conv2d(cin, hidden, 3, dtype=dtype)
        self.conv2 = Conv2d(hidden, 2, 3, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(h)))


class UpdateBlock(nn.Module):
    def __init__(self, cfg: PublishedConfig):
        super().__init__()
        dt = cfg.dtype
        self.encoder = MotionEncoder(cfg)
        self.gru = SepConvGRU(cfg.hidden_dim,
                              cfg.context_dim + cfg.motion_dim, dt)
        self.flow_head = FlowHead(cfg.hidden_dim, cfg.head_dim, dt)
        self.mask = nn.Sequential(
            Conv2d(cfg.hidden_dim, cfg.head_dim, 3, dtype=dt), nn.ReLU(),
            Conv2d(cfg.head_dim, cfg.mask_rate ** 2 * 9, 1, dtype=dt))

    def forward(self, h, inp, corr, flow, want_mask: bool):
        """(h, mask or None, delta flow f32); ``inp`` in the compute
        dtype."""
        mf = self.encoder(flow, corr)
        h = self.gru(h, torch.cat([inp, mf], dim=1))
        delta = self.flow_head(h).float()
        mask = 0.25 * self.mask(h).float() if want_mask else None
        return h, mask, delta


# ---------------------------------------------------------------------------
# Correlation, sampling, upsampling
# ---------------------------------------------------------------------------


_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def _constant(key: tuple, make) -> torch.Tensor:
    """A constant tensor made once per key (its shape and device)."""
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = make()
    return t


def search_points(small: bool, device) -> torch.Tensor:
    """(9, 2) f32 (dx, dy) of a step's pattern, row-major: the 3x3 window
    (``small``) or the 1x9 row."""
    def make():
        if small:
            pts = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
        else:
            pts = [(dx, 0) for dx in range(-4, 5)]
        return torch.tensor(pts, dtype=torch.float32).to(device)

    return _constant(("points", small, str(device)), make)


def pixel_grid(h: int, w: int, device) -> torch.Tensor:
    """(2, h, w) f32 pixel coordinates (x, y)."""
    def make():
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                torch.arange(w, dtype=torch.float32),
                                indexing="ij")
        return torch.stack([xs, ys]).to(device)

    return _constant(("grid", h, w, str(device)), make)


def sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``img`` (B, C, H, W) at pixel coordinates
    ``coords`` (B, h, w, 2) as (x, y), zero outside: (B, C, h, w)."""
    hh, ww = img.shape[-2:]
    dev = coords.device
    a = _constant(("scale", hh, ww, str(dev)),
                  lambda: torch.tensor([2.0 / ww, 2.0 / hh]).to(dev))
    b = _constant(("shift", hh, ww, str(dev)),
                  lambda: torch.tensor([1.0 / ww - 1.0, 1.0 / hh - 1.0])
                  .to(dev))
    grid = torch.addcmul(b, coords, a)  # (2 x + 1) / n - 1
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def agcl_deformable(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                    offset: torch.Tensor, small: bool,
                    groups: int) -> torch.Tensor:
    """AGCL at 1/16 and 1/8: for group g and search point k, the mean over
    the group's channels of f1 times f2 sampled at p + flow(p) + delta_k +
    offset_k(p); (B, groups * 9, h, w), group-major. ``offset`` (B, 18, h,
    w): (x, y) of each point."""
    b, c, h, w = f1.shape
    pts = search_points(small, f1.device)  # (9, 2)
    k = pts.shape[0]
    base = pixel_grid(h, w, f1.device) + flow  # (B, 2, h, w)
    coords = (base.unsqueeze(1) + pts.view(1, k, 2, 1, 1)
              + offset.view(b, k, 2, h, w))  # (B, 9, 2, h, w)
    coords = coords.permute(0, 1, 3, 4, 2).reshape(b, k * h, w, 2)
    right = sample(f2, coords).view(b, groups, c // groups, k, h, w)
    left = f1.view(b, groups, c // groups, 1, h, w)
    return (left * right).mean(dim=2).reshape(b, groups * k, h, w)


def agcl_warped(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                small: bool, groups: int) -> torch.Tensor:
    """AGCL at 1/4: f2 warped once by the flow, then 9 integer shifts of
    the warped map with replicate padding; (B, groups * 9, h, w)."""
    b, c, h, w = f1.shape
    warped = sample(f2, (pixel_grid(h, w, f1.device) + flow)
                    .permute(0, 2, 3, 1))
    if small:  # windows (dy, dx), row-major
        win = F.pad(warped, (1, 1, 1, 1), mode="replicate")
        corr = f1[..., None, None] * win.unfold(2, 3, 1).unfold(3, 3, 1)
    else:
        win = F.pad(warped, (4, 4, 0, 0), mode="replicate")
        corr = f1[..., None] * win.unfold(3, 9, 1)
    corr = corr.reshape(b, groups, c // groups, h, w, 9).mean(dim=2)
    return corr.permute(0, 1, 4, 2, 3).reshape(b, -1, h, w)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor,
                    rate: int) -> torch.Tensor:
    """(B, 2, h, w) -> (B, 2, rate h, rate w): each sub-pixel a softmax-
    weighted mix of the 3x3 neighbourhood of ``rate * flow`` (zero
    padded)."""
    b, _, h, w = flow.shape
    m = torch.softmax(mask.reshape(b, 1, 9, rate, rate, h, w), dim=2)
    up = F.unfold(rate * flow, 3, padding=1).view(b, 2, 9, 1, 1, h, w)
    up = (m * up).sum(dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, rate * h, rate * w)


def hand_over(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The published level hand-over: the flow resized (bilinear, align
    corners) to (h, w) and scaled by -(h / its height)."""
    scale = h / flow.shape[2]
    return -scale * F.interpolate(flow, size=(h, w), mode="bilinear",
                                  align_corners=True)


def sine_encoding(d: int, h: int, w: int, device) -> torch.Tensor:
    """LoFTR's sine position encoding (d, h, w) f32: channel 4k sin(x w_k),
    4k+1 cos(x w_k), 4k+2 sin(y w_k), 4k+3 cos(y w_k), x and y from 1,
    w_k = exp(-2k ln(10000) / (d / 2)); computed in f64, made once per
    shape and device."""
    def make():
        f64 = torch.float64
        omega = torch.exp(torch.arange(0, d // 2, 2, dtype=f64)
                          * (-math.log(10000.0) / (d // 2)))[:, None, None]
        x = torch.arange(1, w + 1, dtype=f64).expand(h, w)
        y = torch.arange(1, h + 1, dtype=f64)[:, None].expand(h, w)
        pe = torch.stack([torch.sin(x * omega), torch.cos(x * omega),
                          torch.sin(y * omega), torch.cos(y * omega)],
                         dim=1).reshape(d, h, w)
        return pe.to(torch.float32).to(device)

    return _constant(("sine", d, h, w, str(device)), make)


# ---------------------------------------------------------------------------
# CUDA graphs of the refinement's steps
# ---------------------------------------------------------------------------


class StepGraphs:
    """The refinement's update a step as a CUDA graph per key (its shapes
    and whether it computes the mask), captured on its first call and
    replayed after: a step costs the host a replay and a few copies
    instead of ~100 launches.

    :meth:`run` copies its arguments into the graph's static inputs (the
    first ``pinned`` only when another tensor is passed than the last
    time: the level's context; none that is the static input itself, as
    :meth:`inputs` gives it to be written in place) and returns the
    graph's static outputs, valid until that graph's next replay. Each
    graph keeps its own memory pool, so no replay overwrites another
    graph's outputs."""

    def __init__(self):
        self.entries: Dict[tuple, list] = {}

    def inputs(self, key: tuple) -> Optional[list]:
        """The static inputs of ``key``'s graph, None before its capture."""
        entry = self.entries.get(key)
        return None if entry is None else entry[1]

    def run(self, key: tuple, fn, args: tuple, pinned: int = 0):
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = self._capture(fn, args)
        graph, inputs, out, last = entry
        for j, (s, a) in enumerate(zip(inputs, args)):
            if s is a:
                continue
            if j < pinned:
                if last[j] is a:
                    continue
                last[j] = a
            s.copy_(a)
        graph.replay()
        return out

    @staticmethod
    def _capture(fn, args: tuple) -> list:
        inputs = [a.clone() for a in args]
        main = torch.cuda.current_stream(inputs[0].device)
        side = torch.cuda.Stream(inputs[0].device)
        side.wait_stream(main)
        with torch.cuda.stream(side):  # cuDNN picks its algorithms here
            fn(*inputs)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*inputs)
        return [graph, inputs, out, [None] * len(args)]


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------


class CREStereo(nn.Module):
    """The published network; :meth:`infer` is its two-pass inference."""

    def __init__(self, cfg: PublishedConfig = PublishedConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.fnet = BasicEncoder(c)
        self.update_block = UpdateBlock(c)
        self.self_att_fn = FeatureTransformer(c.d_model, c.nhead,
                                              ("self", "cross"), c.dtype)
        self.cross_att_fn = FeatureTransformer(c.d_model, c.nhead,
                                               ("cross",), c.dtype)
        n = 2 * c.search_num
        self.conv_offset_16 = Conv2d(c.feat_dim, n, 3, dtype=c.dtype)
        self.conv_offset_8 = Conv2d(c.feat_dim, n, 3, dtype=c.dtype)
        self.graphs = StepGraphs()

    def _offsets(self, fmap: torch.Tensor, conv: Conv2d) -> torch.Tensor:
        return (torch.sigmoid(conv(fmap).float()) - 0.5) * 2.0

    def _attend(self, f1: torch.Tensor, f2: torch.Tensor) -> tuple:
        """The 1/16 maps through ``self_att_fn`` after the sine encoding,
        then through ``cross_att_fn`` (what every 1/16 AGCL call
        correlates)."""
        b, c, h, w = f1.shape
        pe = sine_encoding(c, h, w, f1.device)

        def tokens(x):
            return (x + pe).flatten(2).transpose(1, 2)

        t1, t2 = self.self_att_fn(tokens(f1), tokens(f2))
        t1, t2 = self.cross_att_fn(t1, t2)
        return tuple(t.transpose(1, 2).reshape(b, c, h, w) for t in (t1, t2))

    def _level(self, h, inp, flow, steps: int, maps: tuple,
               offset: Optional[torch.Tensor], on) -> tuple:
        """``steps`` update steps at one level, correlating ``maps`` (the
        deformable AGCL with ``offset``, else the warped one); (h, flow,
        the last step's mask). The AGCL is :func:`agcl.correlate` (kernel
        A1 on a CUDA device, the maps and offset put in its layout once
        here); on a CUDA device it writes into the static input of the
        step's update graph (:class:`StepGraphs`), which then replays."""
        c = self.cfg
        inp = inp.to(c.dtype, memory_format=CHANNELS_LAST)
        h = h.contiguous(memory_format=CHANNELS_LAST)
        f1, f2 = (agcl.kernel_layout(m) for m in maps)
        if offset is not None:
            offset = agcl.kernel_layout(offset)
        graphed = flow.is_cuda and not torch.is_grad_enabled()
        counts = dict(deformable=int(offset is not None),
                      fused=int(flow.is_cuda))
        mask = None
        for i in range(steps):
            small, last = i % 2 == 1, i == steps - 1

            def step(inp, h, corr, flow, last=last):
                h, mask, delta = self.update_block(h, inp, corr, flow,
                                                   want_mask=last)
                return h, flow + delta, mask

            key = ("update", last, tuple(h.shape))
            static = self.graphs.inputs(key) if graphed else None
            with span("guide.agcl", on, **counts):
                corr = agcl.correlate(f1, f2, flow, offset, small, c.groups,
                                      out=None if static is None
                                      else static[2])
            if graphed:
                h, flow, mask = self.graphs.run(key, step,
                                                (inp, h, corr, flow),
                                                pinned=1)
            else:
                h, flow, mask = step(inp, h, corr, flow)
        return h, flow, mask

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                flow_init: Optional[torch.Tensor] = None) -> torch.Tensor:
        """NCHW eyes in [0, 255] -> the published output, -(the convex-
        upsampled flow) (B, 2, H, W): the disparity in channel 0."""
        c = self.cfg
        b = image1.shape[0]
        with span("guide.encoder", image1, images=2 * b):
            x = torch.cat([image1, image2], dim=0) / 255.0 * 2.0 - 1.0
            f1, f2 = self.fnet(x).chunk(2, dim=0)
        net = torch.tanh(f1[:, :c.hidden_dim])
        inp = torch.relu(f1[:, c.hidden_dim:])
        h4, w4 = f1.shape[-2:]
        steps = c.iters if flow_init is not None else 2 * c.iters
        if flow_init is None:
            pooled = {s: [F.avg_pool2d(t, s) for t in (f1, f2, net, inp)]
                      for s in (2, 4)}
            off8 = self._offsets(pooled[2][0], self.conv_offset_8)
            off16 = self._offsets(pooled[4][0], self.conv_offset_16)
            with span("guide.transformer", image1):
                a1, a2 = self._attend(pooled[4][0], pooled[4][1])
        with span("guide.refine", image1, steps=steps):
            if flow_init is None:
                _, _, net16, inp16 = pooled[4]
                flow = torch.zeros(b, 2, *net16.shape[-2:],
                                   device=f1.device)
                _, flow, mask = self._level(net16, inp16, flow, c.iters // 2,
                                            (a1, a2), off16, image1)
                f1_8, f2_8, net8, inp8 = pooled[2]
                flow = hand_over(convex_upsample(flow, mask, c.mask_rate),
                                 *f1_8.shape[-2:])
                _, flow, mask = self._level(net8, inp8, flow, c.iters // 2,
                                            (f1_8, f2_8), off8, image1)
                flow = hand_over(convex_upsample(flow, mask, c.mask_rate),
                                 h4, w4)
            else:
                flow = hand_over(flow_init, h4, w4)
            _, flow, mask = self._level(net, inp, flow, c.iters, (f1, f2),
                                        None, image1)
            return -convex_upsample(flow, mask, c.mask_rate)

    def infer(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        """The published ``test.py``: NCHW eyes (B, 3, H, W) in [0, 255],
        H and W multiples of 32 -> disparity (B, H, W) f32: the pair at
        half size (bilinear, align corners) without ``flow_init``, then the
        full pair seeded with it."""
        h, w = left.shape[-2:]
        if h % MULTIPLE or w % MULTIPLE:
            raise ValueError(f"CREStereo evaluates multiples of {MULTIPLE}: "
                             f"{h}x{w}")
        half = [F.interpolate(e, size=(h // 2, w // 2), mode="bilinear",
                              align_corners=True) for e in (left, right)]
        first = self(*half)
        return self(left, right, flow_init=first)[:, 0]


def eval_shape(h: int, w: int, infer_scale_hd: int) -> tuple:
    """The evaluation size of an (h, w) keyframe: 1/``infer_scale_hd`` from
    720 rows up, each side rounded to the nearest multiple of 32 (halves
    up; 32 at least): 1080x1920 -> 544x960."""
    s = infer_scale_hd if h >= 720 and infer_scale_hd > 1 else 1

    def near(n):
        return max(MULTIPLE, int(n / s / MULTIPLE + 0.5) * MULTIPLE)

    return near(h), near(w)
