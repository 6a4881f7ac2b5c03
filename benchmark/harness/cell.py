"""One run of one cell: set-up, warm-up, the measured window, the traced
sub-window, the comparison with the reference, and the result line.

The window opens at the completion of a batch in the steady state (after
``WARMUP_BATCHES``), lasts ``seconds`` by the host clock, and counts the
frames of every batch whose readback completed inside it. Set-up is the
time from the process's start to the window's opening. With ``trace`` the
matcher and the guidance calls are timed with CUDA events through the
window, and ``PROFILE_BATCHES`` batches after it run under
``torch.profiler``.
"""

from __future__ import annotations

import gc
import json
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark.harness import check, driver as drv, trace as tr
from benchmark.harness.registry import Registry

WARMUP_BATCHES = 3
PROFILE_BATCHES = 24


def _device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return dict(platform=device.type, kind=device.type, count=1,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=chips,
                memory_peak_bytes=int(torch.cuda.max_memory_reserved(device)))


def run(reg: Registry, workload: str, seed: int, seconds: float,
        trace: bool, device="cuda", t_start: float | None = None,
        log=print, keep: dict | None = None) -> dict:
    """The result line's fields for one run; ``log`` takes progress
    lines (standard error in a run). ``keep`` (for tools) receives the
    clip, the sampled batches, the reference's maps of them and the record
    the metrics read."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == "cuda"
    cell = reg.cell(workload)
    config = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    limits = reg.limits(workload)
    metrics = reg.metrics(workload, "per_layer" if trace else "end_to_end")

    def mark(what: str) -> None:
        log(f"set-up {time.perf_counter() - t_start:.3f} s: {what}")

    mark("start of the cell")
    stage, ext, opts = drv.build(reg, config, traffic, device)
    batch = traffic["batch"]
    mark("program built, guidance resolved")
    clip = reg.generator(traffic["generator"])(traffic, seed, device)
    clip = clip["frames"].cpu().numpy()
    mark(f"clip {clip.shape} rendered and on the host")
    if cuda:
        log(f"batch {batch}; the extractor's _auto_batch_size would pick "
            f"{ext._auto_batch_size(clip.shape[1], clip.shape[2])}")

    d = drv.Driver(stage.depth_batch_pipeline, opts, clip, batch, device,
                   stage.host_copy_async)
    matcher = guidance = None
    real_matcher = getattr(stage, "sgbm_disparity", None)
    if trace:
        if real_matcher is None:
            raise RuntimeError("stages/depth.py no longer calls "
                               "sgbm_disparity by that name: the matcher "
                               "cannot be timed")
        matcher = drv.Timed(real_matcher, lambda: d.span("bench.matcher"))
        stage.sgbm_disparity = matcher
        if opts["guidance_fn"] is not None:
            guidance = drv.Timed(opts["guidance_fn"],
                                 lambda: d.span("bench.guidance"))
            opts["guidance_fn"] = guidance
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        for i in range(WARMUP_BATCHES):
            d.step()
            mark(f"warm-up batch {i} launched")
        for t in (matcher, guidance):
            if t is not None:
                t.take()
        sample = check.Reservoir(check.SAMPLE_BATCHES, seed)
        t0 = d.step()["t"]
        frames = batches = 0
        ends = []
        d.launch_s.clear()
        while True:
            done = d.step()
            if done["t"] > t0 + seconds:
                break
            frames += batch
            batches += 1
            ends.append(done["t"] - t0)
            sample.offer((done["start"], done["maps"]))
        d.flush()
        window = dict(frames=frames, batches=batches, setup_s=t0 - t_start)
        log(f"window: {frames} frames in {batches} batches over {seconds} s; "
            f"set-up {window['setup_s']:.3f} s")
        log(_steadiness(ends, d.launch_s, batch))
        timed = {}
        for key, t in (("matcher_ms", matcher), ("guidance_ms", guidance)):
            timed[key] = t.take() if t is not None else []
        traced = {}
        if trace:
            traced = tr.profile_batches(d, PROFILE_BATCHES)
            for t in (matcher, guidance):
                if t is not None:
                    t.take()
            _write_trace(reg.root, workload, seed, traced)
            log(f"trace: {traced.get('device_records')} device records, "
                f"{traced.get('launches')} launches, "
                f"{traced.get('launches_unrecorded')} launches without a "
                f"device record")
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        dev_info = _device_info(device, cell["chips"])
    finally:
        if real_matcher is not None:
            stage.sgbm_disparity = real_matcher
    ext_every = ext.guidance_every
    del d, opts, ext, matcher, guidance
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    h, w_sbs = clip.shape[1], clip.shape[2]
    eye_width = w_sbs if traffic["format"] == "half_sbs" else w_sbs // 2
    guide = config["guide"]
    rec = SimpleNamespace(
        seconds=float(seconds), batch=batch, height=h, eye_width=eye_width,
        keyframes=-(-batch // ext_every) if guide is not None else 0,
        guide_work=(reg.guide(guide["kind"]).work(guide, h, eye_width)
                    if guide is not None else None),
        config=config, traffic=traffic, peak_alloc_bytes=peak,
        trace=traced, **window, **timed)

    t_ref = time.perf_counter()
    reference = check.reference(reg, config, traffic, device)
    refs = []
    got = check.compare(sample.items, clip, reference,
                        config["sgbm"]["num_disparities"], refs)
    if keep is not None:
        keep.update(clip=clip, sample=sample.items, refs=refs,
                    config=config, traffic=traffic, run=rec)
    correct, table = check.verdict(got, limits)
    log(f"reference: {len(sample.items)} batches compared in "
        f"{time.perf_counter() - t_ref:.1f} s")

    values = {}
    for name, unit, read in metrics:
        v = read(rec)
        if v is not None:
            values[name] = {"value": float(v), "unit": unit}
    # attempted: the window's frames and the two batches in flight at its
    # close (their maps came back after it); a failure raises instead
    out = dict(correct=bool(correct),
               attempted=frames + 2 * batch, failed=0, metrics=values,
               device=dev_info)
    if trace:
        out["device"].update(busy_s=traced["busy_s"],
                             window_s=traced["window_s"])
        out["breakdown"] = dict(device_ops=traced["device_ops"],
                                idle_gaps=traced["idle_gaps"])
    out["checked"] = table
    return out


def _steadiness(ends: list, launch_s: list, batch: int) -> str:
    """A progress line on how steady the window ran: frames/s in each 5-s
    slice, and the host's median time to launch a batch (the pinned copy
    and the stage's launches)."""
    slices = [0] * max(1, int(ends[-1] // 5.0) + 1) if ends else [0]
    for t in ends:
        slices[int(t // 5.0)] += batch
    launch = sorted(launch_s)
    med = launch[len(launch) // 2] * 1e3 if launch else float("nan")
    return (f"frames/s by 5-s slice: {[n / 5.0 for n in slices]}; host "
            f"launch {med:.3f} ms a batch (median)")


def _write_trace(root: Path, workload: str, seed: int, traced: dict) -> None:
    """The traced sub-window's summary (a few KB) at a fixed path inside the
    checkout: ``build/bench_trace/<workload>.json``, replaced by each traced
    run."""
    out = root / "build" / "bench_trace" / f"{workload}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(workload=workload, seed=seed, **traced),
                              indent=1))
