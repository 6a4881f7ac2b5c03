"""The control (the reference in the program's place, one precision lower:
TF32 resampling, bfloat16 gray, fp8 guide convolutions) fails each cell's
limits, where the program passes them: at a tiny size on the CPU, and on the
card at the cell's own size (marked ``cuda``)."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import cell, check
from benchmark.harness.registry import Registry


def _program_and_control(reg, name, seed, seconds, device):
    keep = {}
    out = cell.run(reg, name, seed, seconds, False, device,
                   log=lambda m: None, keep=keep)
    low = check.control(keep, reg, device)
    return out, check.verdict(low, reg.limits(name))[0]


@pytest.mark.parametrize("name", ["tiny_hybrid", "tiny_stereo"])
def test_control_fails_at_a_tiny_size(tiny_reg, name):
    out, control_ok = _program_and_control(tiny_reg, name, 11, 3.0, "cpu")
    assert out["correct"]
    assert not control_ok


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hybrid_k4_hsbs", "stereo_hsbs",
                                  "hybrid_k1_hsbs", "stereo_fsbs"])
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    out, control_ok = _program_and_control(Registry(), name, 2**33 + 99,
                                           2.0, "cuda")
    assert out["correct"], out["checked"]
    assert not control_ok
