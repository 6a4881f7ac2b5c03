"""The yardstick's arithmetic: published peaks of the card and the bytes and
operations a step of the depth stage needs, counted from its shapes.

A least time is the larger of the bytes over the memory rate and the
operations over the unit's peak. Bytes count each input read once and each
output written once, whatever an implementation reads again. The matcher's
counts are those of the port's kernel bounds (B1-B4 at 1080p, D=64: 0.4086
ms a frame); a guide's operations are counted by its kind's file
(``benchmark/guides/<kind>.py work``), by unit.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "tf32": 494.7e12, "bf16": 989e12}

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


def step_least_ms(frames: int, h: int, w: int, d: int, keyframes: int,
                  guide_work: dict | None) -> float:
    """A step's arithmetic at the published peaks: the matcher's operations
    at the f32/int32 rate, and with a guide ``keyframes`` forwards of
    ``guide_work`` (``{unit: operations}`` of one), each unit's operations
    at its peak."""
    ms = matcher_ops(frames, h, w, d) / PEAK_OPS_S["f32"] * 1e3
    if guide_work and keyframes:
        ms += keyframes * sum(ops / PEAK_OPS_S[unit]
                              for unit, ops in guide_work.items()) * 1e3
    return ms
