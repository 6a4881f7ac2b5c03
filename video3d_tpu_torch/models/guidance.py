"""Guidance-function wrapper (from :mod:`video3d_tpu.models.guidance`).

The depth stage calls ``fn(left)`` for a monocular backend and
``fn(left, right)`` when ``fn.stereo`` is set.
"""

from __future__ import annotations

from typing import Callable

import torch


class GuidanceFn:
    """Callable guidance backend around an ``nn.Module``.

    ``apply_fn(module, left)`` for monocular backends;
    ``apply_fn(module, left, right)`` when ``stereo=True``. The JAX class
    also carries a ``params`` pytree so that large weights travel into the
    jitted pipeline as arguments, not as compiled constants; a torch
    module holds its own weights, so that argument is dropped here.
    """

    def __init__(self, apply_fn: Callable, module: torch.nn.Module,
                 stereo: bool = False):
        self._apply = apply_fn
        self.module = module
        self.stereo = stereo

    def __call__(self, left: torch.Tensor, right=None) -> torch.Tensor:
        if self.stereo:
            return self._apply(self.module, left, right)
        return self._apply(self.module, left)


def loader_device(device, name: str) -> torch.device:
    """The device a model loader puts its model on: ``cuda`` unless the
    caller names another; raises where CUDA is asked for and missing (no
    fallback to the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{name}: CUDA is not available; pass device=\"cpu\" to run on "
            f"the CPU")
    return device
