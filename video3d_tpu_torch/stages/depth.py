"""Stereo-only depth extraction stage (counterpart of video3d_tpu.stages.depth).

Per batch, on one device: SBS split, 2x Lanczos-4 unsqueeze, BT.601 gray,
the semi-global matcher (:func:`video3d_tpu_torch.ops.stereo.
sgbm_disparity`, whose four kernels run on a CUDA device), clamp of
invalid pixels to 0, fixed-range or per-frame normalisation, uint16 out.
Host I/O -- decode, PNG16 writing, cache keys -- is the JAX package's
JAX-free ``video3d_tpu.core``.

Temporal smoothing (``temporal_smooth``): ``median`` runs the median-of-3
along the frame axis, ``flow`` the flow-guided EMA on a 1/``flow_scale``
gray guide of the left eye (:mod:`video3d_tpu_torch.parallel.temporal`,
kernels B5 and B6). Only ``guidance='none'`` is ported; neural guidance,
hole fill and the sharded/fan-out variants are not yet.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Iterable, Optional

import numpy as np
import torch

from video3d_tpu.core import DepthMapWriter, VideoReader, get_video_info
from video3d_tpu.core.cache import (create_work_directory, depth_cache_dir,
                                    is_depth_cached_range)
from video3d_tpu_torch.ops.flow import FlowEMAParams
from video3d_tpu_torch.ops.image import (resize2d, rgb_to_gray, split_sbs,
                                         unsqueeze_width)
from video3d_tpu_torch.ops.stereo import SGBMParams, sgbm_disparity
from video3d_tpu_torch.parallel.temporal import (TemporalFlowEMAStream,
                                                 TemporalMedianStream)

# Same numeric contract as the JAX stage's ALGO_VERSION 2 (int16 cost,
# 5-path MODE_SGBM); the cache key adds BACKEND so the two never alias.
ALGO_VERSION = 2
BACKEND = "torch"


def gray_pair(frames: torch.Tensor, unsqueeze: bool = True):
    """uint8 SBS RGB batch (B, H, W, 3) -> contiguous f32 gray eyes
    (B, H, W') each: split, optional 2x Lanczos-4 unsqueeze, BT.601."""
    left, right = split_sbs(frames)
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    if unsqueeze:
        # resample each RGB channel's width: (B, H, W/2, 3) -> (B, H, W, 3)
        left = unsqueeze_width(left.movedim(-1, 1)).movedim(1, -1)
        right = unsqueeze_width(right.movedim(-1, 1)).movedim(1, -1)
    return rgb_to_gray(left).contiguous(), rgb_to_gray(right).contiguous()


def disparity_to_uint16(disp: torch.Tensor, num_disparities: int,
                        normalize: str = "fixed") -> torch.Tensor:
    """Clamp invalid/negative to 0 (reference depth.py:374), normalise
    (fixed range 0..num_disparities, or per-frame min-max) to uint16."""
    disp = torch.clamp(disp, min=0.0)
    if normalize == "per_frame":
        dmin = disp.amin(dim=(-2, -1), keepdim=True)
        dmax = disp.amax(dim=(-2, -1), keepdim=True)
        scaled = (disp - dmin) / torch.clamp(dmax - dmin, min=1e-6) * 65535.0
    else:
        scaled = disp * (65535.0 / float(num_disparities))
    # float -> integer truncates toward zero, like .astype(jnp.uint16)
    return torch.clamp(scaled, 0.0, 65535.0).to(torch.int32).to(torch.uint16)


def depth_batch_pipeline(
    frames: torch.Tensor,
    params: SGBMParams = SGBMParams(),
    unsqueeze: bool = True,
    normalize: str = "fixed",
    apply_speckle: bool = True,
    return_guide: bool = False,
    guide_scale: int = 4,
):
    """uint8 SBS RGB batch (B, H, W, 3) -> uint16 depth batch (B, H, W').

    W' is W (unsqueezed anamorphic) or W//2. Runs on ``frames.device``.
    ``return_guide``: also return the bilinear 1/``guide_scale`` gray of
    the left eye, (B, ceil(H/s), ceil(W'/s)) f32 -- the motion guide of
    the flow smoother.
    """
    gl, gr = gray_pair(frames, unsqueeze)
    disp = sgbm_disparity(gl, gr, params, apply_speckle=apply_speckle)
    out = disparity_to_uint16(disp, params.num_disparities, normalize)
    if return_guide:
        h, w = gl.shape[-2], gl.shape[-1]
        s = int(guide_scale)
        return out, resize2d(gl, -(-h // s), -(-w // s), method="bilinear")
    return out


class StereoDepthExtractor:
    """Stereo depth from SBS video on a torch device (stereo-only)."""

    def __init__(
        self,
        work_dir: str = "temp_depth",
        batch_size: Optional[int] = None,
        guidance: str = "none",
        unsqueeze_anamorphic: bool = True,
        normalize: str = "fixed",
        apply_speckle: bool = True,
        temporal_median: bool = False,
        temporal_smooth: Optional[str] = None,
        flow_scale: int = 4,
        params: SGBMParams = SGBMParams(),
        device=None,
    ):
        """``device`` None means ``cuda``, which must be available; the
        plain twins run only when ``device="cpu"`` is asked for.
        ``temporal_smooth``: none|median|flow (``temporal_median=True``
        spells median); ``flow_scale`` 2 or 4 is the guide's reduction."""
        if guidance not in ("none", "stereo_only"):
            raise NotImplementedError(
                f"guidance={guidance!r} is not yet ported (stereo-only)")
        if normalize not in ("fixed", "per_frame"):
            raise ValueError(f"normalize must be fixed|per_frame: {normalize}")
        self.work_dir = create_work_directory(work_dir)
        self.batch_size = batch_size
        self.guidance = guidance
        self.model_checkpoint = "stereo_only"
        self.unsqueeze_anamorphic = bool(unsqueeze_anamorphic)
        self.normalize = normalize
        self.apply_speckle = bool(apply_speckle)
        if temporal_smooth is None:
            temporal_smooth = "median" if temporal_median else "none"
        if temporal_smooth not in ("none", "median", "flow"):
            raise ValueError(
                f"temporal_smooth must be none|median|flow: {temporal_smooth}")
        self.temporal_smooth = temporal_smooth
        if flow_scale not in (2, 4):
            raise ValueError(f"flow_scale must be 2 or 4: {flow_scale}")
        self.flow_scale = int(flow_scale)
        self.params = params
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "StereoDepthExtractor: CUDA is not available; pass "
                "device=\"cpu\" (CLI: --device cpu) to run the plain twins")

    def _auto_batch_size(self, height: int, width: int) -> int:
        """Frames per batch from free device memory.

        The live set peaks in the sweeps: the int16 cost volume and the
        int16 accumulator, H*W'*D each, plus the uploaded frames and maps;
        1.5x headroom over (2 + 2 + 2) bytes per volume element, capped at
        8 (the JAX stage's cap). A CPU device assumes 16 GiB, as the JAX
        stage does without memory stats.
        """
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
        else:
            free = 16 * 2**30
        w_eye = width // 2 * (2 if self.unsqueeze_anamorphic else 1)
        vol = height * w_eye * self.params.num_disparities
        per_frame = int((2 + 2 + 2) * vol * 1.5)
        return min(max(1, int(free * 0.75 / per_frame)), 8)

    def _model_key(self) -> str:
        """Cache-key component covering every output-affecting option,
        tagged with the backend so port and JAX maps never alias."""
        key = f"{self.model_checkpoint}+a{ALGO_VERSION}"
        if self.normalize != "fixed":
            key += f"+norm={self.normalize}"
        if self.temporal_smooth == "median":
            key += "+tmedian"
        elif self.temporal_smooth == "flow":
            key += "+tflow"
            if self.flow_scale != 4:
                key += f"@{self.flow_scale}"
        if not self.apply_speckle:
            key += "+nospeckle"
        default = SGBMParams()
        if self.params != default:
            diff = ",".join(
                f"{f.name}={getattr(self.params, f.name)}"
                for f in dataclasses.fields(SGBMParams)
                if getattr(self.params, f.name) != getattr(default, f.name)
            )
            key += f"+sgbm({diff})"
        return key + f"+{BACKEND}"

    def _smoother(self):
        """A fresh temporal smoother for one run, or None."""
        if self.temporal_smooth == "median":
            return TemporalMedianStream()
        if self.temporal_smooth == "flow":
            # one extra pyramid level at flow_scale 2 keeps the coarsest
            # level at the same absolute resolution as the default
            return TemporalFlowEMAStream(FlowEMAParams(
                levels=3 + (self.flow_scale == 2)))
        return None

    def _run_batches(self, batches: Iterable, cache: Path) -> int:
        """Upload, run, smooth and write ``(frames uint8 (B, H, W, 3),
        valid)`` batches into ``cache``; returns the number of frames read.

        Each batch's ``depth[:valid]`` (and guide) goes through the
        temporal smoother, whose output is written at the indices it
        emits: the median lags one batch and ends with ``flush()``. One
        batch in flight: a batch's maps are copied to the host
        asynchronously and handed to the PNG writer while the next runs.
        """
        cuda = self.device.type == "cuda"
        smoother = self._smoother()
        want_guide = self.temporal_smooth == "flow"
        done = 0
        written = 0
        pending = None  # (host maps, copy-done event, start index, count)
        t0 = time.time()
        with DepthMapWriter(cache) as writer:

            def drain(p):
                host, event, start, n_valid = p
                if event is not None:
                    event.synchronize()
                writer.put(host.numpy(), start, n_valid)

            def stage(maps, start, n_valid):
                nonlocal pending
                event = None
                if cuda:
                    host = torch.empty(maps.shape, dtype=maps.dtype,
                                       pin_memory=True)
                    host.copy_(maps, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(self.device))
                else:
                    host = maps
                if pending is not None:
                    drain(pending)
                pending = (host, event, start, n_valid)

            for frames, valid in batches:
                x = torch.from_numpy(np.ascontiguousarray(frames))
                if cuda:
                    x = x.pin_memory()
                x = x.to(self.device, non_blocking=cuda)
                depth = depth_batch_pipeline(
                    x, params=self.params,
                    unsqueeze=self.unsqueeze_anamorphic,
                    normalize=self.normalize,
                    apply_speckle=self.apply_speckle,
                    return_guide=want_guide,
                    guide_scale=self.flow_scale,
                )
                if want_guide:
                    depth, guide = depth
                if smoother is None:
                    stage(depth, done, valid)
                else:
                    out = (smoother.push(depth[:valid], guide[:valid])
                           if want_guide else smoother.push(depth[:valid]))
                    if out is not None:
                        stage(out, written, out.shape[0])
                        written += out.shape[0]
                done += valid
                if done % 100 < valid:
                    dt = time.time() - t0
                    print(f"  {done} frames ({done / max(dt, 1e-9):.1f} fps)")
            if smoother is not None:
                out = smoother.flush()
                if out is not None:
                    stage(out, written, out.shape[0])
            if pending is not None:
                drain(pending)
        return done

    def process_video_sbs(
        self,
        video_path: str,
        start_frame: int = 0,
        max_frames: Optional[int] = None,
        force: bool = False,
    ) -> Path:
        """Extract depth maps for a frame range; returns the cache dir.

        Idempotent: a complete cache is returned as it is unless ``force``.
        """
        info = get_video_info(str(video_path))
        if info is None:
            raise RuntimeError(f"Cannot probe video: {video_path}")
        n_total = info["frames"] - start_frame if info["frames"] else None
        n_frames = (
            min(n_total, max_frames)
            if (n_total is not None and max_frames is not None)
            else (max_frames if max_frames is not None else n_total)
        )
        cache = depth_cache_dir(
            self.work_dir, str(video_path), start_frame,
            n_frames if n_frames is not None else "all",
            self._model_key(), self.unsqueeze_anamorphic,
        )
        if (not force and n_frames is not None
                and is_depth_cached_range(cache, 0, n_frames)):
            print(f"Using cached depth maps: {cache}")
            return cache
        batch = self.batch_size or self._auto_batch_size(
            info["height"], info["width"])
        print(f"Extracting depth: "
              f"{n_frames if n_frames is not None else '?'} frames, "
              f"batch={batch}, device={self.device}")
        reader = VideoReader(str(video_path), start_frame=start_frame,
                             max_frames=n_frames, batch_size=batch)
        t0 = time.time()
        done = self._run_batches(reader, cache)
        dt = time.time() - t0
        print(f"Depth extraction done: {done} frames in {dt:.1f}s "
              f"({done / max(dt, 1e-9):.1f} fps) -> {cache}")
        return cache
