"""The cell ``crestereo_pub_k4_hsbs`` on the card at its own size: the
program passes its limits, where the control (the reference one precision
lower: fp8 e4m3 convolution and linear operands, TF32 resampling,
bfloat16 gray) and the program with the published CREStereo's two passes
replaced by a constant disparity each fail them (marked ``cuda``)."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import cell, check
from benchmark.harness.registry import Registry

CELL = "crestereo_pub_k4_hsbs"
SEED = 2**33 + 211


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")


@pytest.mark.cuda
def test_control_fails_the_published_crestereo_cell():
    _card()
    reg = Registry()
    keep = {}
    out = cell.run(reg, CELL, SEED, 2.0, False, "cuda", log=lambda m: None,
                   keep=keep)
    assert out["correct"], out["checked"]
    low = check.control(keep, reg, "cuda")
    assert not check.verdict(low, reg.limits(CELL))[0], low


@pytest.mark.cuda
def test_a_constant_guide_fails_the_published_crestereo_cell(monkeypatch):
    _card()
    from video3d_tpu_torch.models import crestereo_net

    def constant(self, left, right):
        return torch.full((left.shape[0], *left.shape[-2:]), 10.0,
                          device=left.device)

    monkeypatch.setattr(crestereo_net.CREStereo, "infer", constant)
    out = cell.run(Registry(), CELL, SEED, 2.0, False, "cuda",
                   log=lambda m: None)
    assert not out["correct"], out["checked"]
