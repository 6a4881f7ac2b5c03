"""Toolchain probe of int16 ops on the card (kernel P).

Counterpart of the JAX package's ``tools/probe_i16.py``, which asks which
int16 vector ops Mosaic lowers on a TPU by running six toy Pallas
kernels. Here the six toy ops are one CUDA kernel (``csrc/probe_i16.cu``)
that computes every op it is asked for in one launch (:func:`probe_all`:
all six; :func:`probe_op`: one), at the probe's (8, 64, 256) int16 shape,
held against the torch expressions on the probe's inputs in [0, 100) and
on inputs over the whole int16 range, where add and add+sub wrap and the
f32 -> int16 cast saturates (as XLA's do); the probe prints OK or FAIL per
op. It stays out of the stage.

Usage: ``python -m video3d_tpu_torch.tools.probe_i16`` on a CUDA card
(``--device cpu`` runs the torch expressions against themselves).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from video3d_tpu_torch.kernels import _build

SHAPE = (8, 64, 256)  # (bb, D, W)-shaped tile, as the JAX probe's

launches = 0  # launches of the CUDA probe kernel


def _low_cols(a: torch.Tensor) -> torch.Tensor:
    return torch.arange(a.shape[-1], device=a.device) < 4


# name -> (op code of csrc/probe_i16.cu: its bit in the kernel's mask,
# inputs, torch expression)
OPS = {
    "i16 add": (0, 2, lambda a, b: a + b),
    "i16 add+sub (ring update)": (1, 3, lambda a, b, c: a + b - c),
    "i16 select/where": (2, 2, lambda a, b: torch.where(_low_cols(a), a, b)),
    "f32->i16 cast (round trip)": (
        3, 1, lambda a: (a.to(torch.float32) * 2.0).clamp(
            -32768, 32767).to(torch.int16)),
    "i16->f32 cast + roll": (
        4, 1, lambda a: torch.roll(a.to(torch.float32), 1,
                                   dims=-1).to(torch.int16)),
    "i16 shift/and (halving)": (5, 1, lambda a: (a >> 1) + (a & 1)),
}


def probe_all_plain(xs, mask: int = (1 << len(OPS)) - 1) -> list:
    """The torch expressions of the ops in ``mask`` (bit k: op code k) on
    the int16 inputs ``xs`` (a, then b and c where an op reads them), in
    op order: the kernel's planes."""
    return [expr(*xs[:n_in]) for code, n_in, expr in OPS.values()
            if mask >> code & 1]


def _launch(xs, mask: int, what: str) -> tuple:
    """The kernel on CUDA tensors: one launch, a plane per op in ``mask``,
    planes n rounded up to 8 elements apart; the planes as views."""
    global launches
    a = xs[0]
    for x in xs:
        _build.require(x, torch.int16, a.dim(), what)
        if x.shape != a.shape:
            raise ValueError(f"{what}: input shapes differ")
    n = a.numel()
    if a.dim() < 1 or n == 0:
        raise ValueError(f"{what}: an empty input")
    planes = bin(mask).count("1")
    out = torch.empty((planes, -(-n // 8) * 8), dtype=torch.int16,
                      device=a.device)
    ptrs = [x.data_ptr() for x in xs] + [None] * (3 - len(xs))
    _build.check(_build.lib().v3d_probe_i16_all(
        *ptrs, out.data_ptr(), n, a.shape[-1], mask, _build.stream_of(a)),
        "v3d_probe_i16_all")
    launches += 1
    return out[:, :n].view((planes, *a.shape)).unbind(0)


def probe_all(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """The six ops of :data:`OPS` on int16 tensors of one shape, in order
    (a sequence of six tensors): one kernel launch for CUDA tensors, the
    torch expressions for CPU ones."""
    if not a.is_cuda:
        return probe_all_plain((a, b, c))
    return _launch((a, b, c), (1 << len(OPS)) - 1, "probe_all")


def probe_op(name: str, *xs: torch.Tensor) -> torch.Tensor:
    """Op ``name`` of :data:`OPS` alone on int16 tensors of one shape: the
    kernel with that op's bit of the mask for CUDA tensors, its torch
    expression for CPU ones."""
    code, n_in, _ = OPS[name]
    if len(xs) != n_in:
        raise ValueError(f"{name}: {n_in} inputs, got {len(xs)}")
    if not xs[0].is_cuda:
        return probe_all_plain(xs, 1 << code)[0]
    return _launch(xs, 1 << code, f"probe {name}")[0]


def probe_inputs(device, seed: int = 0, full_range: bool = False) -> list:
    """Three int16 (8, 64, 256) inputs: in [0, 100), as the JAX probe's, or
    over the whole int16 range with ``full_range``."""
    rng = np.random.default_rng(seed)
    lo, hi = (-32768, 32768) if full_range else (0, 100)
    return [torch.from_numpy(rng.integers(lo, hi, SHAPE).astype(np.int16))
            .to(device) for _ in range(3)]


def run(device="cuda", seed: int = 0) -> dict:
    """All six ops against their torch expressions on ``device``, one
    :func:`probe_all` call on the probe's inputs and one on full-range
    ones; prints one line per op and returns {name: max |kernel -
    expression|} over both."""
    sets = [probe_inputs(device, seed, full) for full in (False, True)]
    outs = [probe_all(*xs) for xs in sets]
    res = {}
    for k, (name, (_, n_in, expr)) in enumerate(OPS.items()):
        diff = 0
        for xs, got in zip(sets, outs):
            diff = max(diff, int((got[k].to(torch.int32) - expr(
                *xs[:n_in]).to(torch.int32)).abs().max().item()))
        print(f"{name:28s} {'OK  ' if diff == 0 else 'FAIL'} "
              f"(sum={int(outs[-1][k].sum(dtype=torch.int64).item())} on "
              f"full-range inputs, max |diff| {diff})")
        res[name] = diff
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("probe_i16: no CUDA device (--device cpu runs the torch "
                  "expressions)", file=sys.stderr)
            return 2
        print(f"device: {torch.cuda.get_device_name(dev)}")
    res = run(dev)
    return 0 if all(v == 0 for v in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
