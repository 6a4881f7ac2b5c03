"""What decides ``correct``: the maps the timed path produced, against the
reference's maps of the same frames.

During the window a seeded reservoir keeps ``SAMPLE_BATCHES`` of the batches
that completed there (their host maps, untouched). Once the window has
closed and the program's state is freed, the reference
(:mod:`benchmark.reference.depth`) computes those batches from the same
clip frames, and :func:`numbers` compares, frame by frame:

- ``worst_off_pct``: over the compared frames, the largest share (%) of a
  frame's pixels whose depth differs from the reference's by more than
  ``OFF_PX`` disparity pixels;
- ``mean_px``: the mean absolute difference over all compared pixels, in
  disparity pixels.

Each number has a limit per cell (``benchmark/workloads/<cell>.json``);
the run is correct when every number is at or under its limit.
"""

from __future__ import annotations

import random

import torch

from benchmark.harness import weights
from benchmark.reference.depth import Reference

SAMPLE_BATCHES = 2
OFF_PX = 1.0


class Reservoir:
    """A uniform sample of ``k`` items from a stream, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def numbers(maps: torch.Tensor, ref: torch.Tensor,
            num_disparities: int) -> dict:
    """The compared numbers of program maps against reference maps, both
    (B, H, W) holding uint16 values."""
    px = 65535.0 / num_disparities  # map units a disparity pixel
    diff = (maps.to(torch.float64) - ref.to(torch.float64)).abs() / px
    off = (diff > OFF_PX).double().mean(dim=(-2, -1)) * 100.0
    return dict(worst_off_pct=float(off.max()), mean_px=float(diff.mean()))


def compare(sample: list, clip, reference, num_disparities: int,
            keep: list | None = None) -> dict:
    """The numbers over every sampled batch: (start in the clip, host
    maps) pairs; ``reference.maps`` takes the clip's frames. ``keep``
    collects the reference's maps."""
    diffs = []
    for start, maps in sample:
        frames = clip[start:start + maps.shape[0]]
        ref = reference.maps(frames)
        if keep is not None:
            keep.append(ref)
        diffs.append(numbers(torch.as_tensor(maps).to(ref.device), ref,
                             num_disparities))
    if not diffs:
        raise RuntimeError("no batch completed inside the window")
    return dict(
        worst_off_pct=max(d["worst_off_pct"] for d in diffs),
        mean_px=sum(d["mean_px"] for d in diffs) / len(diffs))


def reference(reg, config: dict, traffic: dict, device,
              control: bool = False):
    """The plain reference of a configuration and traffic mix: with a
    guide, its kind's forward (``reg.guide``) from the weights the program
    loaded; one precision lower with ``control``."""
    net = None
    if config["guide"] is not None:
        kind = reg.guide(config["guide"]["kind"])
        net = kind.reference(weights.path(kind, config, reg.root, device),
                             config["guide"], device, control)
    return Reference(config, traffic, net, device, control)


def control(keep: dict, reg, device) -> dict:
    """The control's numbers on a run's sampled batches: the reference put
    in the program's place one precision lower (``control=True``), on the
    same frames, against the reference maps the run kept
    (``cell.run(..., keep=...)``)."""
    ctl = reference(reg, keep["config"], keep["traffic"], device,
                    control=True)
    nd = keep["config"]["sgbm"]["num_disparities"]
    parts = [numbers(ctl.maps(keep["clip"][s:s + m.shape[0]]), ref, nd)
             for (s, m), ref in zip(keep["sample"], keep["refs"])]
    return dict(worst_off_pct=max(p["worst_off_pct"] for p in parts),
                mean_px=sum(p["mean_px"] for p in parts) / len(parts))


def verdict(got: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) for every limited number."""
    table = {name: {"value": got[name], "limit": limit}
             for name, limit in limits.items()}
    return all(v["value"] <= v["limit"] for v in table.values()), table
