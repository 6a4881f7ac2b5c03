"""Guide kind ``dpt_large``: DPT-large (HF ``DPTForDepthEstimation``,
``Intel/dpt-large``; arXiv:2103.13413), a monocular guide through the
program's ``guidance: dpt`` path.

Its ``guide`` dict holds HF ``DPTConfig``'s widths (:data:`WIDTHS`) and the
weights' ``dtype``. Weights are a HF checkpoint directory, ``config.json``
and ``model.safetensors`` under HF's names and shapes (:func:`specs`), what
the port's ``load_dpt_guidance`` reads; the reference is
:class:`benchmark.reference.dpt.Net` on the same file. The operation
counts are frozen here, from the shapes, so a later change to the program
cannot move the yardstick; the per-layer metrics ``dpt_backbone_roofline_pct``
and ``attention_roofline_pct`` read :func:`backbone_flops` and
:func:`attention_least_ms`.
"""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.harness.weights import seeded
from benchmark.harness.work import least_ms
from benchmark.reference.dpt import Net, load

# the configuration's keys the program's DPTConfig must equal
WIDTHS = ("image_size", "patch_size", "num_channels", "hidden_size",
          "num_hidden_layers", "num_attention_heads", "intermediate_size",
          "layer_norm_eps", "backbone_out_indices", "neck_hidden_sizes",
          "readout_type", "reassemble_factors", "fusion_hidden_size")
EMBED_STD = 0.02  # cls token and position embeddings
BIAS_STD = 0.02  # every bias, so that no stage's output is degenerate
LAST_CONV = "head.head.4."  # the head's 1x1 convolution to the depth
# the side the port's DPT guidance resizes a keyframe to (models/dpt.py
# make_guidance_fn's infer_size, the Intel/dpt-large preprocessor's size)
INFER = 384


def _fan_in(shape: tuple, transposed: bool = False) -> int:
    """A kernel's fan-in: its input width times its taps (a transposed
    convolution's weight is (in, out, k, k))."""
    taps = 1
    for n in shape[2:]:
        taps *= n
    return (shape[0] if transposed else shape[1]) * taps


def specs(guide: dict) -> dict:
    """{HF name: (shape, std)} of every tensor of the checkpoint, in a fixed
    order: kernels normal(0, fan_in^-1/2), biases normal(0, BIAS_STD),
    layer norm scales 0 here (:func:`weights` sets them to 1), the cls
    token and the position embeddings normal(0, EMBED_STD)."""
    d, m = guide["hidden_size"], guide["intermediate_size"]
    p, c = guide["patch_size"], guide["num_channels"]
    f = guide["fusion_hidden_size"]
    tokens = (guide["image_size"] // p) ** 2 + 1
    out = {}

    def layer(name, shape, transposed=False):
        out[f"{name}.weight"] = (shape, _fan_in(shape, transposed) ** -0.5)
        out[f"{name}.bias"] = ((shape[1] if transposed else shape[0],),
                               BIAS_STD)

    def norm(name):
        out[f"{name}.weight"] = ((d,), 0.0)
        out[f"{name}.bias"] = ((d,), BIAS_STD)

    emb = "dpt.embeddings"
    out[f"{emb}.cls_token"] = ((1, 1, d), EMBED_STD)
    out[f"{emb}.position_embeddings"] = ((1, tokens, d), EMBED_STD)
    layer(f"{emb}.patch_embeddings.projection", (d, c, p, p))
    for i in range(guide["num_hidden_layers"]):
        pre = f"dpt.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            layer(f"{pre}.attention.attention.{name}", (d, d))
        layer(f"{pre}.attention.output.dense", (d, d))
        layer(f"{pre}.intermediate.dense", (m, d))
        layer(f"{pre}.output.dense", (d, m))
        norm(f"{pre}.layernorm_before")
        norm(f"{pre}.layernorm_after")
    norm("dpt.layernorm")  # HF's final layer norm; the neck reads before it
    rs = "neck.reassemble_stage"
    for i, (n, fac) in enumerate(zip(guide["neck_hidden_sizes"],
                                     guide["reassemble_factors"])):
        layer(f"{rs}.layers.{i}.projection", (n, d, 1, 1))
        if fac > 1:
            k = int(fac)
            layer(f"{rs}.layers.{i}.resize", (n, n, k, k), transposed=True)
        elif fac < 1:
            layer(f"{rs}.layers.{i}.resize", (n, n, 3, 3))
    for i in range(len(guide["neck_hidden_sizes"])):
        layer(f"{rs}.readout_projects.{i}.0", (d, 2 * d))
    for i, n in enumerate(guide["neck_hidden_sizes"]):
        shape = (f, n, 3, 3)
        out[f"neck.convs.{i}.weight"] = (shape, _fan_in(shape) ** -0.5)
    for j in range(len(guide["neck_hidden_sizes"])):
        fs = f"neck.fusion_stage.layers.{j}"
        layer(f"{fs}.projection", (f, f, 1, 1))
        # HF's deepest stage has a skip unit too, which it never runs
        for unit in ("residual_layer1", "residual_layer2"):
            for conv in ("convolution1", "convolution2"):
                layer(f"{fs}.{unit}.{conv}", (f, f, 3, 3))
    layer("head.head.0", (f // 2, f, 3, 3))
    layer("head.head.2", (32, f // 2, 3, 3))
    layer("head.head.4", (1, 32, 1, 1))
    return out


def hf_config(guide: dict) -> dict:
    """The checkpoint's ``config.json``: HF ``DPTConfig`` of the widths."""
    return dict({k: guide[k] for k in WIDTHS},
                model_type="dpt", architectures=["DPTForDepthEstimation"],
                hidden_act="gelu", is_hybrid=False, qkv_bias=True,
                head_in_index=-1, torch_dtype=guide["dtype"])


def weights(guide: dict, seed: int, out: Path, device) -> Path:
    """``config.json`` and ``model.safetensors`` (in the guide's ``dtype``)
    of :func:`specs` drawn from ``seed``; returns the directory. The
    head's last convolution takes the magnitudes of its draws: its input is
    a ReLU's, so the depth before the last ReLU is positive, as a trained
    DPT's is, and not clipped to 0 over most of a frame where the draws'
    signs would have it so."""
    import torch
    from safetensors.torch import save_file

    tensors = seeded(specs(guide), seed, device,
                     getattr(torch, guide["dtype"]))
    for k, t in tensors.items():
        if "layernorm" in k and k.endswith(".weight"):
            t.fill_(1.0)
        elif k.startswith(LAST_CONV):
            t.abs_()
    out = Path(out)
    save_file({k: t.cpu().contiguous() for k, t in tensors.items()},
              str(out / "model.safetensors"))
    (out / "config.json").write_text(json.dumps(hf_config(guide), indent=1))
    return out


def _tuple(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


def check(fn, guide: dict) -> None:
    """The program's DPTConfig has the guide's widths, every weight is in
    the guide's ``dtype``, and the guide's ``image_size`` is the side the
    program infers at (the reference infers at ``image_size``)."""
    cfg = getattr(fn.module, "cfg", None)
    want = {k: _tuple(guide[k]) for k in WIDTHS}
    have = {k: _tuple(getattr(cfg, k, None)) for k in WIDTHS}
    dtypes = {str(p.dtype) for p in fn.module.parameters()}
    if (have != want or dtypes != {"torch." + guide["dtype"]}
            or guide["image_size"] != INFER):
        raise RuntimeError(f"the program's guide is not the "
                           f"configuration's: {cfg}, {sorted(dtypes)}")


def reference(path, guide: dict, device, control: bool) -> Net:
    """float32 with TF32 off; the control one precision lower (fp8 e4m3
    backbone and neck products, bfloat16 decoder convolutions)."""
    return Net(load(path), guide, device, "low" if control else "f32")


# -- operation counts: multiply-adds x 2, from the shapes -----------------


def _sides(guide: dict) -> list:
    """The side of each reassembled feature map, from the patch grid."""
    g = guide["image_size"] // guide["patch_size"]
    out = []
    for fac in guide["reassemble_factors"]:
        if fac >= 1:
            out.append(g * int(fac))
        else:  # 3x3, padding 1, stride 1 / fac
            out.append((g - 1) // int(round(1 / fac)) + 1)
    return out


def _resize_flops(c: int, h: int, w: int, h_out: int, w_out: int) -> int:
    """A separable resize as two products, the height first (skipped where
    a side is kept)."""
    ops = 2 * c * h_out * h * w if h != h_out else 0
    return ops + (2 * c * h_out * w * w_out if w != w_out else 0)


def backbone_flops(guide: dict) -> int:
    """One keyframe's ViT: the patch embedding, and per block the q, k, v,
    output and MLP linears and the attention's q k^T and p v."""
    d, m = guide["hidden_size"], guide["intermediate_size"]
    p = guide["patch_size"]
    n = (guide["image_size"] // p) ** 2
    t = n + 1
    patch = 2 * n * guide["num_channels"] * p * p * d
    block = 2 * t * (4 * d * d + 2 * d * m) + 4 * t * t * d
    return patch + guide["num_hidden_layers"] * block


def neck_flops(guide: dict) -> int:
    """The readout projections, the reassemble convolutions and the neck's
    3x3 convolutions to the fusion width."""
    d, f = guide["hidden_size"], guide["fusion_hidden_size"]
    g = guide["image_size"] // guide["patch_size"]
    n = g * g
    ops = 0
    for size, fac, side in zip(guide["neck_hidden_sizes"],
                               guide["reassemble_factors"], _sides(guide)):
        ops += 2 * n * 2 * d * d + 2 * n * d * size
        if fac > 1:  # each input pixel feeds k x k outputs
            ops += 2 * n * int(fac) ** 2 * size * size
        elif fac < 1:
            ops += 2 * side * side * 9 * size * size
        ops += 2 * side * side * 9 * size * f
    return ops


def decoder_flops(guide: dict) -> dict:
    """{unit: operations} of the fusion stages and the head. The residual
    units on the neck's bfloat16 maps (the skip inputs, and the deepest
    stage's input) run in bfloat16; from the first align-corners upsample
    on, the path is float32: convolutions at TF32, the upsamples' products
    at the f32 rate."""
    f = guide["fusion_hidden_size"]
    unit = 2 * 2 * 9 * f * f  # two 3x3 convolutions, per pixel
    ops = {"bf16": 0, "tf32": 0, "f32": 0}
    sides = _sides(guide)[::-1]
    for j, side in enumerate(sides):
        px = side * side
        ops["bf16"] += px * unit  # the skip's unit, or the deepest input's
        if j:
            ops["tf32"] += px * unit
        ops["f32"] += _resize_flops(f, side, side, 2 * side, 2 * side)
        ops["tf32"] += 2 * 4 * px * f * f  # the 1x1 projection
    side = 2 * sides[-1]
    ops["tf32"] += 2 * side * side * 9 * f * (f // 2)
    ops["f32"] += _resize_flops(f // 2, side, side, 2 * side, 2 * side)
    side *= 2
    ops["tf32"] += 2 * side * side * (9 * (f // 2) * 32 + 32)
    return ops


def work(guide: dict, h: int, w: int) -> dict:
    """One forward on an (h, w) eye: the backbone, neck and bfloat16
    residual units at the bf16 rate, the float32 decoder's convolutions at
    TF32, its upsamples and the guidance resizes to the inference square
    and back (3 channels in, 1 out) at the f32 rate."""
    s = guide["image_size"]
    ops = decoder_flops(guide)
    ops["bf16"] += backbone_flops(guide) + neck_flops(guide)
    ops["f32"] += (_resize_flops(guide["num_channels"], h, w, s, s)
                   + _resize_flops(1, s, s, h, w))
    return ops


def attention_least_ms(guide: dict, keyframes: int) -> float:
    """Kernel B7's least time over one forward of ``keyframes``: per block
    one call, the larger of its bfloat16 q, k, v and output moved once at
    3.35 TB/s and its q k^T and p v at 989 TFLOP/s."""
    d = guide["hidden_size"]
    t = (guide["image_size"] // guide["patch_size"]) ** 2 + 1
    nbytes = 4 * keyframes * t * d * 2
    ops = 4 * keyframes * t * t * d
    return guide["num_hidden_layers"] * least_ms(nbytes, ops, "bf16")
