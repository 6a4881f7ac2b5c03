"""Guide kind ``crestereo_lite``: the repo's CREStereo-lite
(``video3d_tpu_torch/models/crestereo.py``), a stereo guide.

Its ``guide`` dict holds the widths (``feat_dim``, ``hidden_dim``,
``context_dim``, ``max_disparity``, ``iters``, ``lookup_radius``,
``corr_levels``), ``conv_dtype`` and ``infer_scale_hd``. Weights are one
``.safetensors`` file of the network's ``state_dict``; the reference is
:class:`benchmark.reference.crestereo.Net`. The operation counts are
frozen copies of the port's ``models/crestereo.py conv_flops``, so a later
change to the program cannot move the yardstick.
"""

from __future__ import annotations

from pathlib import Path

from benchmark.harness.weights import seeded
from benchmark.reference.crestereo import Net, load

# the program's own settings, not widths of the configuration
NOT_WIDTHS = ("kind", "conv_dtype", "infer_scale_hd")


def _convs(guide: dict) -> dict:
    """{name: (cout, cin, k)} of every convolution."""
    enc = [(32, 3, 7), (48, 32, 3), (64, 48, 3)]
    n_lookup = guide["corr_levels"] * (2 * guide["lookup_radius"] + 1) + 1
    hid, ctx = guide["hidden_dim"], guide["context_dim"]
    out = {}
    for name, cout in (("fnet", guide["feat_dim"]), ("cnet", hid + ctx)):
        for i, shape in enumerate(enc + [(cout, 64, 3)], 1):
            out[f"{name}.conv{i}"] = shape
    out["menc"] = (ctx, n_lookup, 3)
    for gate in ("convz", "convr", "convq"):
        out[f"gru.{gate}"] = (hid, hid + 2 * ctx, 3)
    out["head"] = (1, hid, 3)
    return out


def weights(guide: dict, seed: int, out: Path, device) -> Path:
    """Kernels normal(0, 1/sqrt(fan_in)), zero biases, float32, as the
    port's ``load_crestereo_guidance`` reads them."""
    from safetensors.torch import save_file

    specs = {}
    for name, (cout, cin, k) in _convs(guide).items():
        specs[f"{name}.weight"] = ((cout, cin, k, k), (cin * k * k) ** -0.5)
        specs[f"{name}.bias"] = ((cout,), 0.0)
    path = Path(out) / "crestereo_lite.safetensors"
    save_file({k: v.cpu().contiguous() for k, v in
               seeded(specs, seed, device).items()}, str(path))
    return path


def check(fn, guide: dict) -> None:
    cfg = getattr(fn.module, "cfg", None)
    want = {k: v for k, v in guide.items() if k not in NOT_WIDTHS}
    have = {k: getattr(cfg, k, None) for k in want}
    if have != want or str(getattr(cfg, "dtype", None)) != (
            "torch." + guide["conv_dtype"]):
        raise RuntimeError(f"the program's guide is not the "
                           f"configuration's: {cfg}")


def reference(path, guide: dict, device, control: bool) -> Net:
    """bfloat16 convolutions as configured; fp8 ones for the control."""
    net = Net(load(path), guide, device, "fp8" if control else "bf16")
    net.stereo = True
    return net


def work(guide: dict, h: int, w: int) -> dict:
    """The convs at the bf16 rate, the correlation at the f32 rate, at
    the keyframe's inference shape."""
    hk, wk = keyframe_shape(h, w, guide["infer_scale_hd"])
    return {"bf16": conv_flops(guide, hk, wk),
            "f32": corr_flops(guide, hk, wk)}


def conv_flops(cfg: dict, h: int, w: int) -> int:
    """Multiply-adds x 2 of one CREStereo-lite forward's convs on an (h, w)
    pair (frozen copy of ``video3d_tpu_torch/models/crestereo.py
    conv_flops``): the encoder on both eyes, the context encoder on the
    left, and ``iters`` times menc, the three GRU convs and the head at
    1/4. ``cfg`` holds the configuration's widths."""
    def out(n, s):  # conv output length, padding k // 2
        return n if s == 1 else (n - 1) // 2 + 1

    def enc(cout):
        h2, w2 = out(h, 2), out(w, 2)
        h4, w4 = out(h2, 2), out(w2, 2)
        return (h2 * w2 * 32 * 3 * 49 + h2 * w2 * 48 * 32 * 9
                + h4 * w4 * 64 * 48 * 9 + h4 * w4 * cout * 64 * 9), (h4, w4)

    f, (h4, w4) = enc(cfg["feat_dim"])
    cx, _ = enc(cfg["hidden_dim"] + cfg["context_dim"])
    n_lookup = cfg["corr_levels"] * (2 * cfg["lookup_radius"] + 1) + 1
    gru_in = cfg["hidden_dim"] + 2 * cfg["context_dim"]
    it = h4 * w4 * 9 * (n_lookup * cfg["context_dim"]
                        + 3 * gru_in * cfg["hidden_dim"] + cfg["hidden_dim"])
    return 2 * (2 * f + cx + cfg["iters"] * it)


def corr_flops(cfg: dict, h: int, w: int) -> int:
    """Multiply-adds x 2 of the correlation volume at 1/4 resolution:
    max_disparity / 4 shifts of a feat_dim dot product per pixel."""
    h4 = ((h - 1) // 2 + 1 - 1) // 2 + 1
    w4 = ((w - 1) // 2 + 1 - 1) // 2 + 1
    return 2 * cfg["feat_dim"] * h4 * w4 * max(2, cfg["max_disparity"] // 4)


def keyframe_shape(h: int, w: int, infer_scale_hd: int) -> tuple:
    """The shape the guidance runs at: 1/s of (h, w) from 720 rows up."""
    s = infer_scale_hd if h >= 720 and infer_scale_hd > 1 else 1
    return h // s, w // s
