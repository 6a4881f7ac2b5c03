"""The yardstick's arithmetic: published peaks of the card and the bytes and
operations a step of the depth stage needs, counted from its shapes.

A least time is the larger of the bytes over the memory rate and the
operations over the unit's peak. Bytes count each input read once and each
output written once, whatever an implementation reads again. The matcher's
counts are those of the port's kernel bounds (B1-B4 at 1080p, D=64: 0.4086
ms a frame); the CREStereo conv count is a frozen copy of the port's
``models/crestereo.py conv_flops``, so a later change to the program cannot
move the yardstick.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16": 989e12}

# operations per element, as the kernel bounds count them
SWEEP_OPS = 9  # a path step per direction: 4 min, 4 add/sub, 1 acc add
WTA_OPS = 8  # the two minima, the right-image min, compares
COST_OPS = 20  # BT cost and the separable 5x5 box sum per volume element
SPECKLE_OPS = 5 + 3 * 4 + 2  # per pixel: band, running sums of 3 planes


def least_ms(nbytes: float, ops: float = 0.0, unit: str = "f32") -> float:
    """The least time in ms the card could take for ``nbytes`` moved once
    and ``ops`` operations on ``unit``."""
    return max(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[unit]) * 1e3


def matcher_work(frames: int, h: int, w: int, d: int,
                 margin: bool) -> dict:
    """{kernel: (bytes, operations)} of B1-B4 for ``frames`` eye pairs of
    h x w at d disparities, 5 paths, int16 cost and accumulator. ``margin``:
    B3 also writes the f32 confidence margin (the hybrid's blend reads it).
    """
    pix = frames * h * w
    vol = pix * d
    return {
        # two f32 gray eyes in, the int16 volume out
        "B1": (2 * pix * 4 + vol * 2, COST_OPS * vol),
        # the int16 volume in, the int16 horizontal sums out
        "B2": (vol * (2 + 2), 2 * SWEEP_OPS * vol),
        # volume and sums in, the f32 disparity (and margin) out
        "B3": (vol * (2 + 2) + pix * 4 * (2 if margin else 1),
               (3 * SWEEP_OPS + WTA_OPS) * vol),
        # the f32 disparity in and out
        "B4": (2 * pix * 4, SPECKLE_OPS * pix),
    }


def matcher_least_ms(frames: int, h: int, w: int, d: int,
                     margin: bool) -> float:
    """Sum of B1-B4's least times."""
    return sum(least_ms(b, o) for b, o in
               matcher_work(frames, h, w, d, margin).values())


def matcher_ops(frames: int, h: int, w: int, d: int) -> float:
    """Operations of B1-B4, the matcher's arithmetic."""
    return sum(o for _, o in matcher_work(frames, h, w, d, False).values())


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


def step_least_ms(frames: int, h: int, w: int, d: int, keyframes: int,
                  guide: dict | None) -> float:
    """A step's arithmetic at the published peaks: the matcher's operations
    at the f32/int32 rate, and with a guide its convs at the bf16 rate and
    its correlation at the f32 rate, over ``keyframes`` forwards."""
    ms = matcher_ops(frames, h, w, d) / PEAK_OPS_S["f32"] * 1e3
    if guide is not None and keyframes:
        hk, wk = keyframe_shape(h, w, guide["infer_scale_hd"])
        ms += keyframes * (conv_flops(guide, hk, wk) / PEAK_OPS_S["bf16"]
                           + corr_flops(guide, hk, wk) / PEAK_OPS_S["f32"]
                           ) * 1e3
    return ms
