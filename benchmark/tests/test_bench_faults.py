"""A whole run of a tiny cell on the CPU (past the harness's look for a
card), sound and with the timed path broken underneath: ``correct`` holds
for the sound run and comes out false for each fault a cell of this
benchmark can have. There is no exchange between chips to leave out: every
cell runs on one."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import cell

SECONDS = 3.0


def _run(reg, name):
    return cell.run(reg, name, 2**36 + 5, SECONDS, False, "cpu",
                    log=lambda m: None)


def _altered(fn):
    """An answer altered where it is produced: the second frame's map two
    disparity pixels deeper."""
    def broken(frames, **kw):
        maps = fn(frames, **kw).to(torch.int32)
        maps[1] = (maps[1] + 2 * 1024).clamp(max=65535)
        return maps.to(torch.uint16)
    return broken


def _half_batch(fn):
    """Half of the batch left out: the first half computed, its maps
    standing for the rest."""
    def broken(frames, **kw):
        half = fn(frames[:frames.shape[0] // 2], **kw)
        return torch.cat([half, half])[:frames.shape[0]]
    return broken


def _stale_copy(fn):
    """A step that returns its state unchanged: the readback hands over
    the previous batch's maps."""
    last = {}

    def broken(t):
        prev = last.get("maps", t)
        last["maps"] = t.clone()
        return fn(prev)
    return broken


FAULTS = {"altered_answer": ("depth_batch_pipeline", _altered),
          "half_batch": ("depth_batch_pipeline", _half_batch),
          "stale_state": ("host_copy_async", _stale_copy)}


@pytest.mark.parametrize("name", ["tiny_hybrid", "tiny_stereo"])
def test_sound_run_is_correct(tiny_reg, name):
    out = _run(tiny_reg, name)
    assert out["correct"], out["checked"]
    assert list(out)[-1] == "checked"
    assert out["metrics"]["frames_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["tiny_hybrid", "tiny_stereo"])
def test_broken_path_is_not_correct(tiny_reg, monkeypatch, name, fault):
    from video3d_tpu_torch.stages import depth as stage

    attr, wrap = FAULTS[fault]
    monkeypatch.setattr(stage, attr, wrap(getattr(stage, attr)))
    out = _run(tiny_reg, name)
    assert not out["correct"], out["checked"]
