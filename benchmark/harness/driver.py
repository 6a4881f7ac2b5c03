"""The system under test and the loop that drives it.

The program is ``video3d_tpu_torch``'s depth stage. :func:`build` makes a
``StereoDepthExtractor`` from the configuration (its work directory under
``TMPDIR``), lets it resolve its guidance model (``load_model``) from the
weights the guide's kind gives, has the kind check it, and takes the
options its ``_run_batches`` would pass to ``depth_batch_pipeline``.
:class:`Driver` repeats what ``_run_batches`` does for a batch, minus the
PNG writer: a host batch copied into pinned memory and uploaded without
waiting, the stage called, the readback started with ``host_copy_async``,
then the previous batch drained, so one batch is in flight.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark.harness import weights


def build(reg, config: dict, traffic: dict, device):
    """(stage module, extractor, options for ``depth_batch_pipeline``).
    With a guide, the program loads the weights its kind resolves
    (:mod:`benchmark.harness.weights`), and the kind checks what loaded."""
    from video3d_tpu_torch.ops.stereo import SGBMParams
    from video3d_tpu_torch.stages import depth as stage

    ext_cfg = dict(config["extractor"])
    if ext_cfg.pop("temporal_smooth") != "none":
        raise ValueError("the harness drives no temporal smoother")
    kwargs = dict(ext_cfg, **traffic["options"])
    guide = config["guide"]
    kind = reg.guide(guide["kind"]) if guide is not None else None
    if kind is not None:
        kwargs["model_checkpoint"] = str(weights.path(kind, config, reg.root,
                                                      device))
    ext = stage.StereoDepthExtractor(
        work_dir=str(weights.work_dir()), batch_size=traffic["batch"],
        unsqueeze_anamorphic=traffic["format"] == "half_sbs",
        params=SGBMParams(**config["sgbm"]), device=device, **kwargs)
    ext.load_model()
    if kind is not None:
        if ext._guidance_fn is None:
            raise RuntimeError("the guidance model did not load; the run "
                               "would measure stereo-only")
        kind.check(ext._guidance_fn, guide)
    opts = dict(params=ext.params, unsqueeze=ext.unsqueeze_anamorphic,
                normalize=ext.normalize, apply_speckle=ext.apply_speckle,
                guidance_fn=ext._guidance_fn,
                guidance_every=ext.guidance_every,
                stereo_weight=ext.stereo_weight, blend=ext.blend,
                fill_holes=ext.fill_holes, trust_scale=ext.trust_scale,
                horizontal_route=ext.horizontal_route)
    return stage, ext, opts


class Timed:
    """Wraps a callable with CUDA events around each call; ``take()``
    returns the milliseconds of the calls since the last take (it waits
    for them). Attributes of the callable (a guidance fn's ``stereo``)
    show through."""

    def __init__(self, fn, span):
        self.fn = fn
        self.span = span
        self.events = []

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __call__(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with self.span():
            start.record()
            out = self.fn(*args, **kwargs)
            end.record()
        self.events.append((start, end))
        return out

    def take(self) -> list:
        ms = []
        for start, end in self.events:
            end.synchronize()
            ms.append(start.elapsed_time(end))
        self.events = []
        return ms


class Driver:
    """One batch in flight through ``pipeline`` over a host clip (N, H, W,
    3) uint8, cycled in batches of ``batch``."""

    def __init__(self, pipeline, opts: dict, clip: np.ndarray, batch: int,
                 device, host_copy_async):
        if clip.shape[0] % batch:
            raise ValueError("the clip's length must be a multiple of the "
                             "batch")
        self.pipeline = pipeline
        self.opts = opts
        self.clip = clip
        self.batch = batch
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.host_copy_async = host_copy_async
        self.k = 0
        self.pending = None
        self.launch_s = []  # host seconds of each _launch
        self.span = lambda name: contextlib.nullcontext()

    def _launch(self):
        start = (self.k * self.batch) % self.clip.shape[0]
        with self.span("bench.upload"):
            x = torch.from_numpy(self.clip[start:start + self.batch])
            if self.cuda:
                x = x.pin_memory()
            x = x.to(self.device, non_blocking=self.cuda)
        with self.span("bench.pipeline"):
            maps = self.pipeline(x, **self.opts)
        with self.span("bench.readback"):
            host, event = self.host_copy_async(maps)
        item = (self.k, start, host, event)
        self.k += 1
        return item

    def _drain(self, item):
        k, start, host, event = item
        with self.span("bench.drain"):
            if event is not None:
                event.synchronize()
        return dict(k=k, start=start, maps=host, t=time.perf_counter())

    def step(self):
        """Launch the next batch, then drain the one before it; returns
        that one's record (k, clip start, host maps, completion time) or
        None on the first step."""
        t = time.perf_counter()
        item = self._launch()
        self.launch_s.append(time.perf_counter() - t)
        done = self._drain(self.pending) if self.pending else None
        self.pending = item
        return done

    def flush(self):
        """Drain the batch in flight; its record, or None."""
        done = self._drain(self.pending) if self.pending else None
        self.pending = None
        return done

