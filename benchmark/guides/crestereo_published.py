"""Guide kind ``crestereo_published``: the published CREStereo (Li et al.,
CVPR 2022, arXiv:2203.11483; github.com/megvii-research/CREStereo), a
stereo guide through the program's ``guidance: crestereo`` path, which
picks the network by the weights' names.

Its ``guide`` dict holds the widths (:data:`WIDTHS`), ``conv_dtype`` and
``infer_scale_hd``. Weights are one ``.safetensors`` file under the
published ``state_dict`` names (:func:`specs`); the reference is
:class:`benchmark.reference.crestereo_published.Net` on the same file.
The operation counts are frozen here, from the shapes, so a later change
to the program cannot move the yardstick; the per-layer metric
``crestereo_refine_roofline_pct`` reads :func:`refine_least_ms`.

Shapes, at an eye of (h, w): the evaluation size (he, we)
(:func:`eval_shape`), the first pass at (he / 2, we / 2) with ``iters`` / 2
steps at 1/16 and at 1/8 and ``iters`` at 1/4 of it, the second at (he,
we) with ``iters`` steps at 1/4.
"""

from __future__ import annotations

from pathlib import Path

from benchmark.harness.weights import seeded
from benchmark.harness.work import HBM_BYTES_S, PEAK_OPS_S
from benchmark.reference.crestereo_published import Net, eval_shape, load

# the configuration's keys the program's PublishedConfig must equal
WIDTHS = ("encoder_dims", "feat_dim", "hidden_dim", "context_dim",
          "corr_dims", "flow_dims", "motion_dim", "head_dim", "search_num",
          "groups", "mask_rate", "d_model", "nhead", "iters")
# the flow head's last convolution: its kernel's draws scaled by
# FLOW_GAIN, its x bias -FLOW_DRIFT (a step's push toward positive
# disparity; see weights)
FLOW_GAIN = 0.05
FLOW_DRIFT = 0.025
LAST_CONV = "update_block.flow_head.conv2"


def _conv(out: dict, name: str, cout: int, cin: int, kh: int, kw: int = 0):
    kw = kw or kh
    out[f"{name}.weight"] = ((cout, cin, kh, kw), (cin * kh * kw) ** -0.5)
    out[f"{name}.bias"] = ((cout,), 0.0)


def _linear(out: dict, name: str, cout: int, cin: int):
    out[f"{name}.weight"] = ((cout, cin), cin ** -0.5)


def specs(guide: dict) -> dict:
    """{published name: (shape, std)} of every tensor, in a fixed order:
    kernels normal(0, fan_in^-1/2), biases 0, layer-norm scales 0 here
    (:func:`weights` sets them to 1)."""
    out = {}
    d1, d2, d3 = guide["encoder_dims"]
    _conv(out, "fnet.conv1", d1, 3, 7)
    cin = d1
    for i, (d, stride) in enumerate(((d1, 1), (d2, 2), (d3, 1)), 1):
        for j in (0, 1):
            pre = f"fnet.layer{i}.{j}"
            _conv(out, f"{pre}.conv1", d, cin, 3)
            _conv(out, f"{pre}.conv2", d, d, 3)
            if j == 0 and (stride != 1 or cin != d):
                _conv(out, f"{pre}.downsample.0", d, cin, 1)
            cin = d
    _conv(out, "fnet.conv2", guide["feat_dim"], d3, 1)
    u = "update_block"
    c1, c2 = guide["corr_dims"]
    f1, f2 = guide["flow_dims"]
    hid, ctx = guide["hidden_dim"], guide["context_dim"]
    _conv(out, f"{u}.encoder.convc1", c1,
          guide["groups"] * guide["search_num"], 1)
    _conv(out, f"{u}.encoder.convc2", c2, c1, 3)
    _conv(out, f"{u}.encoder.convf1", f1, 2, 7)
    _conv(out, f"{u}.encoder.convf2", f2, f1, 3)
    _conv(out, f"{u}.encoder.conv", guide["motion_dim"] - 2, c2 + f2, 3)
    gru_in = hid + ctx + guide["motion_dim"]
    for i, (kh, kw) in ((1, (1, 5)), (2, (5, 1))):
        for gate in "zrq":
            _conv(out, f"{u}.gru.conv{gate}{i}", hid, gru_in, kh, kw)
    _conv(out, f"{u}.flow_head.conv1", guide["head_dim"], hid, 3)
    _conv(out, f"{u}.flow_head.conv2", 2, guide["head_dim"], 3)
    _conv(out, f"{u}.mask.0", guide["head_dim"], hid, 3)
    _conv(out, f"{u}.mask.2", guide["mask_rate"] ** 2 * 9, guide["head_dim"],
          1)
    d = guide["d_model"]
    for name, n in (("self_att_fn", 2), ("cross_att_fn", 1)):
        for i in range(n):
            pre = f"{name}.layers.{i}"
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                _linear(out, f"{pre}.{proj}", d, d)
            _linear(out, f"{pre}.mlp.0", 2 * d, 2 * d)
            _linear(out, f"{pre}.mlp.2", d, 2 * d)
            for norm in ("norm1", "norm2"):
                out[f"{pre}.{norm}.weight"] = ((d,), 0.0)
                out[f"{pre}.{norm}.bias"] = ((d,), 0.0)
    for s in (16, 8):
        _conv(out, f"conv_offset_{s}", 2 * guide["search_num"],
              guide["feat_dim"], 3)
    return out


def weights(guide: dict, seed: int, out: Path, device) -> Path:
    """Float32 tensors of :func:`specs` drawn from ``seed``, unit
    layer-norm scales; the flow head's last convolution's kernel scaled by
    ``FLOW_GAIN`` and its x bias ``-FLOW_DRIFT``, so that the 60 steps move
    the flow by a fraction of a pixel each, toward a disparity of about
    800 ``FLOW_DRIFT`` pixels at a 1080p eye, and keep it in the frame."""
    from safetensors.torch import save_file

    tensors = seeded(specs(guide), seed, device)
    for k, t in tensors.items():
        if ".norm" in k and k.endswith(".weight"):
            t.fill_(1.0)
    tensors[LAST_CONV + ".weight"].mul_(FLOW_GAIN)
    tensors[LAST_CONV + ".bias"][0] = -FLOW_DRIFT
    path = Path(out) / "crestereo_published.safetensors"
    save_file({k: v.cpu().contiguous() for k, v in tensors.items()},
              str(path))
    return path


def _tuple(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


def check(fn, guide: dict) -> None:
    """The program's network is the published one at the guide's widths
    and ``iters``, its convolutions in ``conv_dtype``, its weights
    float32."""
    cfg = getattr(fn.module, "cfg", None)
    want = {k: _tuple(guide[k]) for k in WIDTHS}
    have = {k: _tuple(getattr(cfg, k, None)) for k in WIDTHS}
    dtypes = {str(p.dtype) for p in fn.module.parameters()}
    if (type(fn.module).__name__ != "CREStereo" or have != want
            or str(getattr(cfg, "dtype", None)) != "torch."
            + guide["conv_dtype"] or dtypes != {"torch.float32"}):
        raise RuntimeError(f"the program's guide is not the "
                           f"configuration's: {cfg}, {sorted(dtypes)}")


def reference(path, guide: dict, device, control: bool) -> Net:
    """float32 with TF32 off; the control rounds each convolution's and
    linear's operands to fp8 e4m3."""
    return Net(load(path), guide, device, control)


# -- operation counts: multiply-adds x 2, from the shapes -----------------


def _down(n: int) -> int:
    """A side after a conv with stride 2 and padding k // 2."""
    return (n - 1) // 2 + 1


def encoder_flops(guide: dict, h: int, w: int) -> int:
    """``fnet`` on one eye of (h, w)."""
    d1, d2, d3 = guide["encoder_dims"]
    h2, w2 = _down(h), _down(w)
    h4, w4 = _down(h2), _down(w2)
    ops = h2 * w2 * d1 * 3 * 49 + 4 * h2 * w2 * d1 * d1 * 9  # conv1, layer1
    ops += h4 * w4 * (d2 * d1 * 9 + d2 * d2 * 9 + d2 * d1)  # layer2.0
    ops += h4 * w4 * 2 * d2 * d2 * 9  # layer2.1
    ops += h4 * w4 * (d3 * d2 * 9 + d3 * d3 * 9 + d3 * d2)  # layer3.0
    ops += h4 * w4 * 2 * d3 * d3 * 9  # layer3.1
    ops += h4 * w4 * guide["feat_dim"] * d3  # conv2
    return 2 * ops


def step_flops(guide: dict, px: int, mask: bool) -> int:
    """One update step on px positions: the motion encoder, both GRU
    halves, the flow head, and the mask head where ``mask``."""
    c1, c2 = guide["corr_dims"]
    f1, f2 = guide["flow_dims"]
    hid, head = guide["hidden_dim"], guide["head_dim"]
    m = guide["motion_dim"]
    gru_in = hid + guide["context_dim"] + m
    ops = (guide["groups"] * guide["search_num"] * c1 + c1 * c2 * 9
           + 2 * f1 * 49 + f1 * f2 * 9 + (c2 + f2) * (m - 2) * 9
           + 6 * gru_in * hid * 5 + hid * head * 9 + head * 2 * 9)
    if mask:
        ops += hid * head * 9 + head * guide["mask_rate"] ** 2 * 9
    return 2 * px * ops


def _levels(guide: dict, h: int, w: int) -> list:
    """(positions, steps) of each level's update steps over a forward on
    an (h, w) eye: 1/16, 1/8 and 1/4 of the half-size pass, then 1/4 of
    the full one."""
    he, we = eval_shape(h, w, guide["infer_scale_hd"])
    it = guide["iters"]
    q = [(he // 2 // s) * (we // 2 // s) for s in (16, 8, 4)]
    return [(q[0], it // 2), (q[1], it // 2), (q[2], it),
            ((he // 4) * (we // 4), it)]


def refine_flops(guide: dict, h: int, w: int) -> int:
    """The update steps of one forward (a mask head a level)."""
    return sum((steps - 1) * step_flops(guide, px, False)
               + step_flops(guide, px, True)
               for px, steps in _levels(guide, h, w))


def agcl_bytes(guide: dict, h: int, w: int) -> int:
    """The AGCL calls of one forward: per call both float32 feature maps
    read once and the float32 correlation (groups x 9 maps) written
    once."""
    ch = guide["feat_dim"]
    k = guide["groups"] * guide["search_num"]
    return sum(steps * px * 4 * (2 * ch + k)
               for px, steps in _levels(guide, h, w))


def corr_flops(guide: dict, h: int, w: int) -> int:
    """The AGCL's products of one forward: per step and position, 9
    search points of a feat_dim product (each group's mean)."""
    return sum(steps * px * 2 * guide["search_num"] * guide["feat_dim"]
               for px, steps in _levels(guide, h, w))


def attention_flops(guide: dict, h: int, w: int) -> dict:
    """{unit: operations} of the first pass's transformers at 1/16: six
    layer applications (self on both maps, cross both ways, and
    ``cross_att_fn`` both ways), each with its q, k, v, merge and MLP
    linears (bf16) and the linear attention's float32 sums (phi(k)^T v and
    phi(q) kv, and the normaliser)."""
    he, we = eval_shape(h, w, guide["infer_scale_hd"])
    t = (he // 32) * (we // 32)
    d = guide["d_model"]
    dh = d // guide["nhead"]
    linear = 2 * t * (4 * d * d + 2 * d * 2 * d + 2 * d * d)
    sums = 2 * t * d * dh * 2 + 2 * t * d
    return {"bf16": 6 * linear, "f32": 6 * sums}


def work(guide: dict, h: int, w: int) -> dict:
    """One forward on an (h, w) eye pair: the convolutions (the encoder on
    both eyes of both passes, the offsets, the update steps) and the
    transformers' linears at the bf16 rate; the correlation and the
    attention's sums at the f32 rate. Resizes, sampling, norms, the
    convex upsampling and element-wise steps are not counted."""
    he, we = eval_shape(h, w, guide["infer_scale_hd"])
    enc = 2 * (encoder_flops(guide, he // 2, we // 2)
               + encoder_flops(guide, he, we))
    offsets = sum(2 * (he // 2 // s) * (we // 2 // s) * 9 * guide["feat_dim"]
                  * 2 * guide["search_num"] for s in (16, 8))
    att = attention_flops(guide, h, w)
    return {"bf16": enc + offsets + refine_flops(guide, h, w) + att["bf16"],
            "f32": corr_flops(guide, h, w) + att["f32"]}


def refine_least_ms(guide: dict, h: int, w: int, keyframes: int) -> float:
    """The least time of span ``guide.refine`` over a batch: its update
    steps' operations at 989 TFLOP/s (bf16), plus the AGCL's features read
    once and its output written once at 3.35 TB/s, for the ``keyframes``
    forwards of (h, w) eyes."""
    return keyframes * (refine_flops(guide, h, w) / PEAK_OPS_S["bf16"]
                        + agcl_bytes(guide, h, w) / HBM_BYTES_S) * 1e3
