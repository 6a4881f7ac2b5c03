"""Plain forward of the published CREStereo (Li et al., CVPR 2022,
arXiv:2203.11483; github.com/megvii-research/CREStereo ``nets/`` and
``test.py``), from weights under the published ``state_dict`` names.

The network of the configuration's ``guide`` widths:

- input x = 2 (img / 255) - 1 for both eyes; the flow f is the offset from
  a left pixel to its match in the right image (f_x = -disparity);
- ``fnet``: conv 7x7/2, instance norm (no affine, eps 1e-5), ReLU; three
  layers of two residual blocks (the first of ``layer2`` with stride 2);
  a block is y = ReLU(IN(conv3x3(x))), y = ReLU(IN(conv3x3(y))),
  ReLU(x' + y), x' = IN(conv1x1(x)) where the block's weights have a
  ``downsample`` (a stride or a width change), else x; then a 1x1 conv.
  F1 and F2 of the two eyes; net = tanh(F1's first ``hidden_dim``
  channels), inp = ReLU(the rest);
- the 1/8 and 1/16 maps (F1, F2, net, inp) by 2x2 and 4x4 average
  pooling; the search offsets (sigmoid(conv_offset_s(F1_s)) - 0.5) * 2;
- at 1/16: LoFTR's sine encoding added (channel 4k sin(x w_k), 4k+1
  cos(x w_k), 4k+2 sin(y w_k), 4k+3 cos(y w_k), x and y from 1, w_k =
  exp(-2k ln(10000) / (d / 2))), then ``self_att_fn`` (a self layer on
  each map, a cross layer: F1 against F2, then F2 against the new F1);
  a layer is q = x Wq, k = s Wk, v = s Wv in ``nhead`` heads, phi = elu
  + 1, out_l = phi(q_l) sum_s phi(k_s)^T (v_s / S) / (phi(q_l) sum_s
  phi(k_s) + 1e-6) S, m = LN(merge(out)), m = LN(MLP([x, m])), x + m;
- AGCL, step i with the 1x9 pattern (dx -4..4) when i is even and the 3x3
  one when odd; per group g of channels and search point k the mean over
  the group's channels of F1 times a right value: at 1/16 and 1/8 the
  right map sampled bilinearly (zero outside) at p + f(p) + delta_k +
  o_k(p), where the 1/16 maps first pass through ``cross_att_fn`` (at
  every call); at 1/4 the right map warped once, W(p) = F2(p + f(p)), then
  read at p + delta_k with replicate padding; the maps group-major;
- the update block: cor = ReLU(convc2(ReLU(convc1(c)))), flo =
  ReLU(convf2(ReLU(convf1(f)))), mf = [ReLU(conv([cor, flo])), f]; the
  SepConvGRU on [inp, mf] (1x5 gates, then 5x1: z, r = sigmoid, q =
  tanh(conv([r h, x])), h = (1 - z) h + z q); delta = flow_head(h); mask =
  0.25 mask(h); f += delta;
- convex upsampling x4: a softmax of the mask over 9 taps per sub-pixel
  weighting the 3x3 unfold (zero padded) of 4 f;
- the cascade: f_16 = 0, iters / 2 steps at 1/16, the upsampled flow
  resized (bilinear, align corners) to the 1/8 grid times -(the grids'
  height ratio), iters / 2 steps at 1/8, the same to 1/4; with
  ``flow_init`` the 1/4 flow is flow_init handed over the same way; then
  iters steps at 1/4; the output -(the upsampled flow);
- inference (``test.py``): the pair at half size (bilinear, align
  corners) without ``flow_init``, then the full pair with the first
  pass's output as ``flow_init``; the disparity is channel 0.

Eyes are resized (the reference's bilinear resample, OpenCV's centre
alignment, as ``test.py``'s ``cv2.resize``) to the evaluation size: from
720 rows up 1/``infer_scale_hd``, each side rounded to the nearest
multiple of 32 (halves up); the disparity is scaled by W / w_eval and
resized back.

Departures from the published code, none of which changes what is
computed: the sampling is written with ``grid_sample(align_corners=False)``
and pixel x at (2x + 1) / W - 1 (the published ``bilinear_sampler``'s
pixel coordinates and zero padding, defined for a map one pixel high or
wide); every step computes the mask, but only each level's last is
upsampled (inference returns the last prediction alone); the second pass
skips the 1/8 and 1/16 maps and the transformers, which it never reads;
keyframes run one at a time (the published AGCL takes one pair).

Precision: float32 with TF32 off throughout. ``control=True`` first rounds
each convolution's and linear's input and weight per tensor to float8
e4m3, as :mod:`benchmark.reference.crestereo` does for its control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.crestereo import _fp8
from benchmark.reference.depth import exact_float32
from benchmark.reference.image import resize2d

MULTIPLE = 32  # the evaluation size's multiple


def load(path) -> dict:
    """The weights file's tensors, float32."""
    from safetensors.torch import load_file

    return {k: v.to(torch.float32) for k, v in load_file(str(path)).items()}


def eval_shape(h: int, w: int, infer_scale_hd: int) -> tuple:
    s = infer_scale_hd if h >= 720 and infer_scale_hd > 1 else 1
    return tuple(max(MULTIPLE, int(n / s / MULTIPLE + 0.5) * MULTIPLE)
                 for n in (h, w))


def pattern(small: bool) -> list:
    """The step's search points (dx, dy), row-major."""
    if small:
        return [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return [(dx, 0) for dx in range(-4, 5)]


def sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear samples of img (1, C, H, W) at pixel coordinates x, y
    (1, h, w), zero outside."""
    hh, ww = img.shape[-2:]
    grid = torch.stack([(2.0 * x + 1.0) / ww - 1.0,
                        (2.0 * y + 1.0) / hh - 1.0], dim=-1)
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def sine_encoding(d: int, h: int, w: int) -> torch.Tensor:
    pe = torch.zeros(d, h, w, dtype=torch.float64)
    x = torch.arange(1, w + 1, dtype=torch.float64)[None, :].expand(h, w)
    y = torch.arange(1, h + 1, dtype=torch.float64)[:, None].expand(h, w)
    for k in range(d // 4):
        omega = math.exp(-2 * k * math.log(10000.0) / (d // 2))
        pe[4 * k] = torch.sin(x * omega)
        pe[4 * k + 1] = torch.cos(x * omega)
        pe[4 * k + 2] = torch.sin(y * omega)
        pe[4 * k + 3] = torch.cos(y * omega)
    return pe.to(torch.float32)


class Net:
    """The forward of one weights dict (float32) on one device."""

    stereo = True

    def __init__(self, weights: dict, guide: dict, device,
                 control: bool = False):
        self.w = {k: v.to(device) for k, v in weights.items()}
        self.g = guide
        self.control = control

    # -- layers ----------------------------------------------------------

    def conv(self, x, name, stride=1):
        w, b = self.w[name + ".weight"], self.w[name + ".bias"]
        if self.control:
            x, w = _fp8(x), _fp8(w)
        kh, kw = w.shape[-2:]
        return F.conv2d(x, w, b, stride=stride, padding=(kh // 2, kw // 2))

    def linear(self, x, name):
        w = self.w[name + ".weight"]
        if self.control:
            x, w = _fp8(x), _fp8(w)
        return F.linear(x, w)

    def layer_norm(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"],
                            self.w[name + ".bias"], 1e-5)

    def block(self, x, name, stride):
        y = F.relu(F.instance_norm(self.conv(x, f"{name}.conv1", stride),
                                   eps=1e-5))
        y = F.relu(F.instance_norm(self.conv(y, f"{name}.conv2"), eps=1e-5))
        if f"{name}.downsample.0.weight" in self.w:
            x = F.instance_norm(self.conv(x, f"{name}.downsample.0", stride),
                                eps=1e-5)
        return F.relu(x + y)

    def encoder(self, x):
        x = F.relu(F.instance_norm(self.conv(x, "fnet.conv1", 2), eps=1e-5))
        for i, stride in ((1, 1), (2, 2), (3, 1)):
            x = self.block(x, f"fnet.layer{i}.0", stride)
            x = self.block(x, f"fnet.layer{i}.1", 1)
        return self.conv(x, "fnet.conv2")

    def attention_layer(self, x, src, name):
        n, length, d = x.shape
        heads = self.g["nhead"]
        q = self.linear(x, f"{name}.q_proj").view(n, length, heads, -1)
        k = self.linear(src, f"{name}.k_proj").view(n, -1, heads, d // heads)
        v = self.linear(src, f"{name}.v_proj").view(n, -1, heads, d // heads)
        q, k = F.elu(q) + 1.0, F.elu(k) + 1.0
        s = v.shape[1]
        kv = torch.einsum("nshd,nshv->nhdv", k, v / s)
        z = 1.0 / (torch.einsum("nlhd,nhd->nlh", q, k.sum(dim=1)) + 1e-6)
        out = torch.einsum("nlhd,nhdv,nlh->nlhv", q, kv, z) * s
        m = self.layer_norm(self.linear(out.reshape(n, length, d),
                                        f"{name}.merge"), f"{name}.norm1")
        m = self.linear(F.relu(self.linear(torch.cat([x, m], dim=-1),
                                           f"{name}.mlp.0")), f"{name}.mlp.2")
        return x + self.layer_norm(m, f"{name}.norm2")

    def transformer(self, t1, t2, name, kinds):
        for i, kind in enumerate(kinds):
            layer = f"{name}.layers.{i}"
            if kind == "self":
                t1, t2 = (self.attention_layer(t1, t1, layer),
                          self.attention_layer(t2, t2, layer))
            else:
                t1 = self.attention_layer(t1, t2, layer)
                t2 = self.attention_layer(t2, t1, layer)
        return t1, t2

    # -- correlation -----------------------------------------------------

    def agcl(self, f1, f2, flow, offset, small, att=False):
        """At 1/16 and 1/8 (``offset`` given): the sampled search points,
        the maps first through ``cross_att_fn`` where ``att``; at 1/4
        (``offset`` None): the warped map's replicate-padded shifts."""
        _, c, h, w = f1.shape
        ys, xs = torch.meshgrid(torch.arange(h, device=f1.device,
                                             dtype=torch.float32),
                                torch.arange(w, device=f1.device,
                                             dtype=torch.float32),
                                indexing="ij")
        x0, y0 = xs + flow[:, 0], ys + flow[:, 1]
        if att:
            t1, t2 = (m.flatten(2).transpose(1, 2) for m in (f1, f2))
            t1, t2 = self.transformer(t1, t2, "cross_att_fn", ("cross",))
            f1, f2 = (t.transpose(1, 2).reshape(1, c, h, w)
                      for t in (t1, t2))
        if offset is None:
            warped = sample(f2, x0, y0)
            warped = F.pad(warped, (4, 4, 1, 1), mode="replicate")
        groups = self.g["groups"]
        cg = c // groups
        out = []
        for g in range(groups):
            left = f1[:, g * cg:(g + 1) * cg]
            for k, (dx, dy) in enumerate(pattern(small)):
                if offset is None:
                    right = warped[:, g * cg:(g + 1) * cg,
                                   1 + dy:1 + dy + h, 4 + dx:4 + dx + w]
                else:
                    right = sample(f2[:, g * cg:(g + 1) * cg],
                                   x0 + dx + offset[:, 2 * k],
                                   y0 + dy + offset[:, 2 * k + 1])
                out.append((left * right).mean(dim=1))
        return torch.stack(out, dim=1)

    # -- update ----------------------------------------------------------

    def update(self, net, inp, corr, flow):
        u = "update_block"
        cor = F.relu(self.conv(F.relu(self.conv(corr, f"{u}.encoder.convc1")),
                               f"{u}.encoder.convc2"))
        flo = F.relu(self.conv(F.relu(self.conv(flow, f"{u}.encoder.convf1")),
                               f"{u}.encoder.convf2"))
        mf = torch.cat([F.relu(self.conv(torch.cat([cor, flo], dim=1),
                                         f"{u}.encoder.conv")), flow], dim=1)
        x = torch.cat([inp, mf], dim=1)
        for i in (1, 2):
            hx = torch.cat([net, x], dim=1)
            z = torch.sigmoid(self.conv(hx, f"{u}.gru.convz{i}"))
            r = torch.sigmoid(self.conv(hx, f"{u}.gru.convr{i}"))
            q = torch.tanh(self.conv(torch.cat([r * net, x], dim=1),
                                     f"{u}.gru.convq{i}"))
            net = (1.0 - z) * net + z * q
        delta = self.conv(F.relu(self.conv(net, f"{u}.flow_head.conv1")),
                          f"{u}.flow_head.conv2")
        mask = 0.25 * self.conv(F.relu(self.conv(net, f"{u}.mask.0")),
                                f"{u}.mask.2")
        return net, mask, delta

    def upsample(self, flow, mask):
        rate = self.g["mask_rate"]
        n, _, h, w = flow.shape
        m = torch.softmax(mask.view(n, 1, 9, rate, rate, h, w), dim=2)
        up = F.unfold(rate * flow, 3, padding=1).view(n, 2, 9, 1, 1, h, w)
        up = (m * up).sum(dim=2)
        return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, rate * h, rate * w)

    @staticmethod
    def hand_over(flow, h, w):
        return -(h / flow.shape[2]) * F.interpolate(
            flow, size=(h, w), mode="bilinear", align_corners=True)

    # -- network ---------------------------------------------------------

    def level(self, net, inp, flow, steps, f1, f2, offset, att=False):
        for i in range(steps):
            corr = self.agcl(f1, f2, flow, offset, i % 2 == 1, att)
            net, mask, delta = self.update(net, inp, corr, flow)
            flow = flow + delta
        return flow, mask

    def forward(self, im1, im2, flow_init=None):
        """One pair (1, 3, H, W) in [0, 255] -> -(the upsampled flow)
        (1, 2, H, W)."""
        g = self.g
        x = torch.cat([im1, im2]) / 255.0 * 2.0 - 1.0
        f1, f2 = self.encoder(x).chunk(2)
        net = torch.tanh(f1[:, :g["hidden_dim"]])
        inp = F.relu(f1[:, g["hidden_dim"]:])
        h4, w4 = f1.shape[-2:]
        steps = g["iters"]
        if flow_init is None:
            p8 = [F.avg_pool2d(t, 2) for t in (f1, f2, net, inp)]
            p16 = [F.avg_pool2d(t, 4) for t in (f1, f2, net, inp)]
            off8 = (torch.sigmoid(self.conv(p8[0], "conv_offset_8"))
                    - 0.5) * 2.0
            off16 = (torch.sigmoid(self.conv(p16[0], "conv_offset_16"))
                     - 0.5) * 2.0
            c, h16, w16 = p16[0].shape[1:]
            pe = sine_encoding(c, h16, w16).to(f1.device)
            t1, t2 = ((m + pe).flatten(2).transpose(1, 2)
                      for m in p16[:2])
            t1, t2 = self.transformer(t1, t2, "self_att_fn",
                                      ("self", "cross"))
            a1, a2 = (t.transpose(1, 2).reshape(1, c, h16, w16)
                      for t in (t1, t2))
            flow = torch.zeros(1, 2, h16, w16, device=f1.device)
            flow, mask = self.level(p16[2], p16[3], flow, steps // 2, a1, a2,
                                    off16, att=True)
            flow = self.hand_over(self.upsample(flow, mask),
                                  *p8[0].shape[-2:])
            flow, mask = self.level(p8[2], p8[3], flow, steps // 2, p8[0],
                                    p8[1], off8)
            flow = self.hand_over(self.upsample(flow, mask), h4, w4)
        else:
            flow = self.hand_over(flow_init, h4, w4)
        flow, mask = self.level(net, inp, flow, steps, f1, f2, None)
        return -self.upsample(flow, mask)

    def infer(self, left, right):
        """One pair (1, 3, H, W) at its evaluation size -> disparity
        (1, H, W): the half-size pass, then the full one seeded by it."""
        h, w = left.shape[-2:]
        half = [F.interpolate(e, size=(h // 2, w // 2), mode="bilinear",
                              align_corners=True) for e in (left, right)]
        first = self.forward(*half)
        return self.forward(left, right, flow_init=first)[:, 0]

    def guidance(self, left: torch.Tensor, right: torch.Tensor,
                 image_mode: str) -> torch.Tensor:
        """RGB eyes (B, H, W, 3) in [0, 255] -> disparity (B, H, W)
        float64, one keyframe at a time."""
        h, w = left.shape[1], left.shape[2]
        he, we = eval_shape(h, w, self.g["infer_scale_hd"])
        out = []
        with torch.no_grad(), exact_float32():
            for i in range(left.shape[0]):
                ls, rs = (resize2d(e[i:i + 1].movedim(-1, 1), he, we,
                                   "bilinear", image_mode).to(torch.float32)
                          for e in (left, right))
                disp = self.infer(ls, rs).to(torch.float64) * (w / we)
                out.append(resize2d(disp, h, w, "bilinear", image_mode))
        return torch.cat(out)
