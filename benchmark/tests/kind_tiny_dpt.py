"""Guide kind ``tiny_dpt``, for the tests alone: a monocular guide through
the program's DPT path (``guidance: dpt``) at a tiny width, its weights
written from a seed in the layout of a HuggingFace checkpoint directory
(``config.json`` and ``model.safetensors``, what the port's
``load_dpt_guidance`` reads), and HuggingFace ``DPTForDepthEstimation`` in
float32 as its plain forward. The tests copy this file into a temporary
checkout as ``benchmark/guides/tiny_dpt.py``: a second kind added as new
files alone.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from benchmark.harness.weights import seeded
from benchmark.reference.image import resize2d

HF_KEYS = ("image_size", "patch_size", "hidden_size", "num_hidden_layers",
           "num_attention_heads", "intermediate_size",
           "backbone_out_indices", "neck_hidden_sizes", "fusion_hidden_size")
INFER = 384  # the side the port's DPT guidance resizes a keyframe to


def _hf_config(guide: dict):
    import transformers

    return transformers.DPTConfig(
        num_channels=3, readout_type="project", is_hybrid=False,
        **{k: guide[k] for k in HF_KEYS})


def weights(guide: dict, seed: int, out: Path, device) -> Path:
    import transformers
    from safetensors.torch import save_file

    shapes = {k: tuple(v.shape) for k, v in transformers.DPTForDepthEstimation(
        _hf_config(guide)).state_dict().items()}
    specs = {k: (s, 0.1 if len(s) == 1 else 0.02 if "embeddings" in k
                 else float(torch.tensor(s[1:]).prod()) ** -0.5)
             for k, s in shapes.items()}
    tensors = seeded(specs, seed, device)
    for k, t in tensors.items():
        if "layernorm" in k and k.endswith(".weight"):
            t.fill_(1.0)
    out = Path(out)
    save_file({k: t.cpu().contiguous() for k, t in tensors.items()},
              str(out / "model.safetensors"))
    (out / "config.json").write_text(json.dumps(_hf_config(guide).to_dict()))
    return out


def check(fn, guide: dict) -> None:
    cfg = getattr(fn.module, "cfg", None)
    want = {k: tuple(v) if isinstance(v, list) else v
            for k, v in guide.items() if k in HF_KEYS}
    have = {k: getattr(cfg, k, None) for k in HF_KEYS}
    dtype = next(fn.module.parameters()).dtype
    if have != want or str(dtype) != "torch." + guide["dtype"]:
        raise RuntimeError(f"the program's guide is not the "
                           f"configuration's: {cfg}, {dtype}")


class _Net:
    stereo = False

    def __init__(self, model, dtype):
        self.model, self.dtype = model, dtype

    def guidance(self, left, right, image_mode):
        """The left eye's relative depth: /255, (x - 0.5) / 0.5, resized
        to INFER square, the forward, resized back."""
        h, w = left.shape[1], left.shape[2]
        x = (left.to(torch.float64) / 255.0 - 0.5) / 0.5
        x = resize2d(x.movedim(-1, 1), INFER, INFER, "bilinear", image_mode)
        with torch.no_grad():
            depth = self.model(pixel_values=x.to(self.dtype)).predicted_depth
        return resize2d(depth.to(torch.float64), h, w, "bilinear",
                        image_mode)


def reference(path, guide: dict, device, control: bool):
    import transformers
    from safetensors.torch import load_file

    model = transformers.DPTForDepthEstimation(_hf_config(guide))
    model.load_state_dict(load_file(str(Path(path) / "model.safetensors")))
    dtype = torch.bfloat16 if control else torch.float32
    return _Net(model.to(device=device, dtype=dtype).eval(), dtype)


def work(guide: dict, h: int, w: int) -> dict:
    """The ViT's matrix products at the bf16 rate, at INFER square."""
    t = (INFER // guide["patch_size"]) ** 2 + 1
    d, m = guide["hidden_size"], guide["intermediate_size"]
    per_layer = 2 * t * (4 * d * d + 2 * d * m) + 4 * t * t * d
    return {"bf16": guide["num_hidden_layers"] * per_layer}
