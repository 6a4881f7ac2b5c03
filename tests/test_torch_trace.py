"""The port's span recorder (``video3d_tpu_torch/core/trace.py``) on the CPU.

Spans record only under ``torch.profiler`` and only in its active steps;
the depth stage's spans nest as its layers do, with the frame and keyframe
counts; their host times are on the clock of the profiler's own host
events; the summary and the Chrome-trace merge are plain arithmetic; and
the CLI's ``--profile-dir`` writes a trace that holds the spans.
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from tests.conftest import make_test_video
from video3d_tpu_torch.core import trace
from video3d_tpu_torch.models.crestereo import (CREStereoConfig,
                                                CREStereoLite,
                                                load_crestereo_guidance)
from video3d_tpu_torch.ops.stereo import SGBMParams
from video3d_tpu_torch.stages.depth import depth_batch_pipeline

PARAMS = SGBMParams(num_disparities=16)


@pytest.fixture(autouse=True)
def fresh_recorder():
    trace.reset()
    yield
    trace.reset()


def _frames(b=2, h=24, w_sbs=64, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (b, h, w_sbs, 3),
                                         dtype=np.uint8))


@pytest.fixture(scope="module")
def tiny_guide(tmp_path_factory):
    """The CREStereo guidance fn on seeded tiny weights, f32, on the CPU."""
    from safetensors.torch import save_file

    torch.manual_seed(0)
    path = tmp_path_factory.mktemp("crestereo") / "tiny.safetensors"
    save_file(CREStereoLite(CREStereoConfig.tiny()).state_dict(), str(path))
    return load_crestereo_guidance(path, cfg=CREStereoConfig.tiny(),
                                   dtype=torch.float32, device="cpu")


def _children(recs, parent):
    return [r["name"] for r in recs if r["parent"] == parent]


def test_nothing_recorded_outside_a_profiler():
    depth_batch_pipeline(_frames(), params=PARAMS)
    assert trace.records() == []
    assert trace.summary() == {}
    first = trace.span("stage", frames=2)
    assert trace.span("matcher.cost") is first
    with first:
        pass
    assert trace.records() == []


def test_spans_record_in_the_active_steps_only():
    frames = _frames()
    seen = []
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=2)) as prof:
        for _ in range(3):
            depth_batch_pipeline(frames, params=PARAMS)
            seen.append(trace.summary().get("stage", {}).get("count", 0))
            prof.step()
    assert seen == [0, 1, 2]  # the warm-up step records nothing
    recs = trace.records()
    assert [r["batch"] for r in recs if r["name"] == "stage"] == [0, 1]
    assert {r["batch"] for r in recs} == {0, 1}
    # after the profile, nothing more
    depth_batch_pipeline(frames, params=PARAMS)
    assert trace.summary()["stage"]["count"] == 2


def test_span_tree_and_counts_of_the_hybrid(tiny_guide):
    b, k = 3, 2
    with profile(activities=[ProfilerActivity.CPU]):
        depth_batch_pipeline(_frames(b), params=PARAMS, guidance_fn=tiny_guide,
                             guidance_every=k, fill_holes=True,
                             return_guide=True)
    recs = trace.records()
    (stage,) = [i for i, r in enumerate(recs) if r["name"] == "stage"]
    assert recs[stage]["parent"] is None and recs[stage]["counts"] == {
        "frames": b}
    assert _children(recs, stage) == [
        "stage.eyes", "stage.gray", "stage.matcher", "stage.fill",
        "stage.guidance", "stage.quantize", "stage.guide_out"]
    idx = {r["name"]: i for i, r in enumerate(recs)}
    assert _children(recs, idx["stage.matcher"]) == [
        "matcher.cost", "matcher.horizontal", "matcher.vertical",
        "matcher.speckle", "matcher.confidence"]
    assert _children(recs, idx["stage.guidance"]) == ["guide.forward",
                                                      "stage.blend"]
    assert recs[idx["guide.forward"]]["counts"] == {"keyframes": -(-b // k)}
    # below 720 rows the guide runs at full size: no resize in
    assert _children(recs, idx["guide.forward"]) == [
        "guide.features", "guide.corr", "guide.gru", "guide.resize_out"]
    assert all(r["batch"] == 0 for r in recs)
    assert all(r["start_ns"] <= r["end_ns"] for r in recs)
    for r in recs:
        if r["parent"] is not None:
            p = recs[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]
    # no CUDA device: no device times
    assert all(r["device_ms"] is None for r in recs)
    table = trace.summary()
    assert table["stage"]["counts"] == {"frames": b}
    assert table["guide.forward"]["counts"] == {"keyframes": 2}
    assert table["stage"]["device_count"] == 0


def test_guide_spans_at_hd_resize_in_and_out(tiny_guide):
    """From 720 rows the guide runs at half size: a resize in, and a resize
    out after the forward's own upsample."""
    rng = np.random.default_rng(1)
    left, right = (torch.from_numpy(rng.uniform(0, 255, (1, 720, 32, 3))
                                    .astype(np.float32)) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("guide.forward", keyframes=1):
            out = tiny_guide(left, right)
    assert out.shape == (1, 720, 32)
    recs = trace.records()
    assert _children(recs, 0) == [
        "guide.resize_in", "guide.features", "guide.corr", "guide.gru",
        "guide.resize_out", "guide.resize_out"]
    assert recs[0]["batch"] is None  # no stage span around it
    assert trace.summary()["guide.resize_out"]["count"] == 2


def test_spans_share_the_profilers_host_clock():
    """Each span's host interval holds the profiler's CPU events opened
    inside it, and none of those opened outside it, with a few
    milliseconds between spans."""
    a = torch.randn(64, 64)
    frames = _frames()
    depth_batch_pipeline(frames, params=PARAMS)  # fills the shape caches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with trace.span("probe"):
                torch.mm(a, a)
            time.sleep(0.003)
        for _ in range(2):
            depth_batch_pipeline(frames, params=PARAMS)
            time.sleep(0.003)
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CPU]
    recs = trace.records()
    mms = sorted(e for e in events if e[2] == "aten::mm")
    probes = [r for r in recs if r["name"] == "probe"]
    assert len(mms) == 3 and len(probes) == 3
    for r, (s, e, _) in zip(probes, mms):
        inside = [m for m in mms if r["start_ns"] <= m[0] and m[1]
                  <= r["end_ns"]]
        assert inside == [(s, e, "aten::mm")]
    stages = [r for r in recs if r["name"] == "stage"]
    t0 = stages[0]["start_ns"]
    t1 = stages[-1]["end_ns"]
    ops = [e for e in events if e[2].startswith("aten::") and t0 <= e[0]
           and e[1] <= t1]
    per_stage = [sum(1 for e in ops if r["start_ns"] <= e[0]
                     and e[1] <= r["end_ns"]) for r in stages]
    # every op between the two batches' spans lies in one of them, and
    # both batches, the same work, hold the same number
    assert per_stage[0] > 0 and per_stage[0] == per_stage[1]
    assert sum(per_stage) == len(ops)


def _rec(name, parent, start_ms, end_ms, device_ms=None, **counts):
    r = trace._Record()
    r.name, r.parent, r.batch, r.counts = name, parent, 0, counts
    r.device, r.events, r.device_ms = None, None, device_ms
    r.start_ns, r.end_ns = int(start_ms * 1e6), int(end_ms * 1e6)
    return r


def test_summary_arithmetic_on_hand_made_records(tmp_path):
    rec = trace.Recorder()
    rec.records = [
        _rec("stage", None, 0.0, 10.0, 8.0, frames=8),
        _rec("stage.matcher", 0, 1.0, 4.0, 5.5),
        _rec("stage", None, 20.0, 32.5, 9.0, frames=8),
        _rec("stage.matcher", 2, 21.0, 23.0),
        _rec("guide.forward", 2, 24.0, 30.0, keyframes=2),
    ]
    table = rec.summary()
    assert list(table) == ["stage", "stage.matcher", "guide.forward"]
    assert table["stage"] == dict(count=2, host_ms=22.5, device_ms=17.0,
                                  device_count=2, counts={"frames": 16})
    assert table["stage.matcher"] == dict(count=2, host_ms=5.0,
                                          device_ms=5.5, device_count=1,
                                          counts={})
    assert table["guide.forward"]["counts"] == {"keyframes": 2}
    text = trace.format_summary(table).splitlines()
    assert len(text) == 4 and text[1].split()[:4] == [
        "stage", "2", "22.500", "17.000"]
    assert text[3].split()[3:] == ["-", "keyframes=2"]

    # merged into a Chrome trace on its own time base
    base = 1_000_000
    path = tmp_path / "t.json"
    path.write_text(json.dumps(dict(baseTimeNanoseconds=base, traceEvents=[
        dict(name="aten::mm", ph="X", pid=1, tid=1, ts=0.5, dur=1.0)])))
    assert trace.merge_chrome_trace(path, rec) == 5
    doc = json.loads(path.read_text())
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    assert [e["name"] for e in spans] == [r.name for r in rec.records]
    assert spans[2]["ts"] == (20.0e6 - base) / 1e3
    assert spans[2]["dur"] == 12.5e3
    assert spans[0]["args"] == {"frames": 8, "batch": 0, "device_ms": 8.0}
    assert {e["pid"] for e in spans} == {trace.TRACK_PID}
    assert doc["traceEvents"][0]["name"] == "aten::mm"


def test_cli_profile_dir_writes_a_trace_with_the_spans(tmp_path, capsys):
    from video3d_tpu_torch.cli.depth import main

    video = tmp_path / "sbs.mp4"
    make_test_video(video, n_frames=3, width=64, height=24)
    out = tmp_path / "prof"
    assert main([str(video), "--stereo-only", "--device", "cpu",
                 "--work-dir", str(tmp_path / "wd"), "--batch-size", "2",
                 "--profile-dir", str(out)]) == 0
    (path,) = out.glob("*.json")
    doc = json.loads(path.read_text())
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    own = [e for e in events if e.get("cat") != "program_span"]
    stages = [e for e in events if e.get("cat") == "program_span"
              and e["name"] == "stage"]
    assert len(stages) == 2  # 3 frames in batches of 2
    t0 = min(e["ts"] for e in own)
    t1 = max(e["ts"] + e.get("dur", 0) for e in own)
    assert all(t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 for e in stages)
    printed = capsys.readouterr().out
    assert "Profile: " in printed and "extract.upload" in printed
    assert trace.records() == []  # the CLI leaves the recorder empty
