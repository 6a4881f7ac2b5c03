"""Depth upscaling + encode stage (counterpart of
:mod:`video3d_tpu.stages.upscale`).

Reads a depth PNG16 sequence, upscales it on a torch device to the
geometry of a 4K source and writes H.264 at the source's fps, or a PNG16
sequence with ``png16_out``. Methods (:mod:`video3d_tpu_torch.ops.guided`):

* ``method='adaptive'`` (the default) -- per-pixel mix of the color guided
  upsample and the plain one by the local agreement of depth and guide
  edges;
* ``method='guided'`` -- the edge-preserving guided filter on the 4K RGB
  frames, with a luma (``guide_mode='gray'``, computed on the host with
  cv2) or full RGB guide;
* ``method='scale'`` -- plain bilinear resize, the reference's ffmpeg
  ``scale``.

Encode contract of the reference (its upscale.py:47-63): h264, crf 18,
preset medium, yuv420p. The output is named
``depth_4k_<dirname>_<method>[_<guide_mode>].mp4`` (a directory of that
name without ``.mp4`` for PNG16), so runs of different methods never
answer for each other; an existing output short-circuits unless
``force``. The encoded video carries the top 8 bits of the 16-bit depth.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from video3d_tpu_torch.core import (DepthMapWriter,
                                    SegmentParallelVideoWriter, VideoReader,
                                    VideoWriter, get_video_info,
                                    list_depth_frames, load_depth_png16)
from video3d_tpu_torch.ops.guided import (adaptive_upsample, guided_upsample,
                                          plain_upsample)
from video3d_tpu_torch.stages.depth import host_copy_async

METHODS = ("adaptive", "guided", "scale")


class DepthUpscaler:
    """Upscale a depth-map sequence to 4K on a torch device and encode."""

    def __init__(
        self,
        work_dir: str = "temp_upscale",
        use_nvenc: bool = False,  # accepted for CLI parity; selects libx264
        method: str = "adaptive",
        batch_size: int = 4,
        radius: int = 8,
        eps: float = 1e-3,
        guide_mode: str = "gray",
        crf: int = 18,
        preset: str = "medium",
        encode_workers: int = 1,
        encode_threads: int = 0,
        device=None,
    ):
        """``method`` adaptive|guided|scale; ``guide_mode`` gray|color is
        the guided method's guide (adaptive always uses the color one).
        ``crf``/``preset`` follow the reference encode contract;
        ``encode_workers`` > 1 encodes segments on parallel threads,
        ``encode_threads`` is x264's own thread count (0 = auto).
        ``device`` None means ``cuda``, which must be available; the CPU
        runs only when ``device="cpu"`` is asked for."""
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}: {method}")
        if guide_mode not in ("gray", "color"):
            raise ValueError(f"guide_mode must be gray|color: {guide_mode}")
        self.work_dir = Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.use_nvenc = use_nvenc
        self.method = method
        self.batch_size = int(batch_size)
        self.radius = int(radius)
        self.eps = float(eps)
        self.guide_mode = guide_mode
        self.crf = int(crf)
        self.preset = str(preset)
        self.encode_workers = int(encode_workers)
        self.encode_threads = int(encode_threads)
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DepthUpscaler: CUDA is not available; pass device=\"cpu\" "
                "(CLI: --device cpu) to run on the CPU")
        self.writer_backend: Optional[str] = None  # what the last run wrote with

    def output_name(self, depth_dir: Path, png16_out: bool) -> str:
        """``depth_4k_<dirname>_<method>[_<guide_mode>]`` (+ ``.mp4``)."""
        tag = self.method + (f"_{self.guide_mode}"
                             if self.method == "guided" else "")
        return f"depth_4k_{depth_dir.name}_{tag}" + ("" if png16_out else ".mp4")

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x

    def _upscale(self, depth: np.ndarray, guide: Optional[np.ndarray],
                 out_h: int, out_w: int, out_dtype: str) -> torch.Tensor:
        """One batch on the device; ``guide`` None resizes plainly."""
        d = self._upload(depth)
        if guide is None:
            return plain_upsample(d, out_h, out_w, out_dtype=out_dtype)
        if self.method == "adaptive":
            return adaptive_upsample(d, self._upload(guide), out_h, out_w,
                                     radius=self.radius, eps=self.eps,
                                     out_dtype=out_dtype)
        if self.guide_mode == "gray":
            # luma on the host (SIMD cvtColor): one channel to upload
            import cv2

            guide = np.stack([cv2.cvtColor(g, cv2.COLOR_RGB2GRAY)
                              for g in guide])
        return guided_upsample(d, self._upload(guide), out_h, out_w,
                               radius=self.radius, eps=self.eps,
                               guide_mode=self.guide_mode,
                               out_dtype=out_dtype)

    def _writer(self, output_path: Path, png16_out: bool, out_w: int,
                out_h: int, fps: float):
        if png16_out:
            self.writer_backend = "png16"
            return DepthMapWriter(output_path)
        if self.encode_workers > 1:
            self.writer_backend = f"segment-parallel x{self.encode_workers}"
            return SegmentParallelVideoWriter(
                str(output_path), out_w, out_h, fps,
                workers=self.encode_workers, crf=self.crf,
                preset=self.preset,
                threads=self.encode_threads if self.encode_threads > 0 else 1)
        writer = VideoWriter(str(output_path), out_w, out_h, fps,
                             use_nvenc=self.use_nvenc, crf=self.crf,
                             preset=self.preset, threads=self.encode_threads)
        self.writer_backend = writer.backend
        return writer

    def process_depth_upscaling(
        self,
        depth_dir: str,
        video_4k_path: str,
        output_path: Optional[str] = None,
        force: bool = False,
        max_frames: Optional[int] = None,
        png16_out: bool = False,
        guide_start_frame: int = 0,
    ) -> Path:
        """Upscale ``depth_dir``'s PNG sequence to the 4K video's geometry.

        Returns the video's path, or with ``png16_out`` a directory of
        uint16 ``depth_%06d.png`` maps. ``guide_start_frame`` pairs guide
        frame ``guide_start_frame + i`` with depth frame ``i`` (the
        alignment offset on the 4K timeline). Batches whose guide frames
        have run out are resized plainly. One batch is in flight: its
        maps are copied to the host asynchronously and written while the
        next batch loads and runs.
        """
        depth_dir = Path(depth_dir)
        frames = list_depth_frames(depth_dir)
        if max_frames is not None:
            frames = frames[:max_frames]
        if not frames:
            raise RuntimeError(f"No depth maps found in {depth_dir}")

        info = get_video_info(str(video_4k_path))
        if info is None:
            raise RuntimeError(f"Cannot probe 4K video: {video_4k_path}")
        out_w, out_h, fps = info["width"], info["height"], info["fps"]

        if output_path is None:
            output_path = self.work_dir / self.output_name(depth_dir,
                                                           png16_out)
        output_path = Path(output_path)
        if output_path.exists() and not force:
            if not png16_out or any(output_path.glob("depth_*.png")):
                print(f"Output already exists: {output_path}")
                return output_path

        print(f"Upscaling {len(frames)} depth maps -> {out_w}x{out_h} "
              f"@ {fps:.3f} fps ({self.method}, device={self.device})")
        guide_reader = None
        if self.method != "scale":
            guide_reader = iter(VideoReader(
                str(video_4k_path), start_frame=int(guide_start_frame),
                max_frames=len(frames), batch_size=self.batch_size))
        # device-side quantization: read back 1-2 bytes a pixel
        out_dtype = "uint16" if png16_out else "uint8"

        t0 = time.time()
        n_done = 0
        with self._writer(output_path, png16_out, out_w, out_h,
                          fps) as writer:
            pending = None  # (host maps, copy-done event, start, valid)

            def drain(p):
                host, event, start, n_valid = p
                if event is not None:
                    event.synchronize()
                out = host.numpy()
                if png16_out:
                    writer.put(out, start, n_valid)
                else:
                    for j in range(n_valid):
                        writer.write(out[j])

            for i in range(0, len(frames), self.batch_size):
                chunk = frames[i:i + self.batch_size]
                valid = len(chunk)
                depth = np.stack([load_depth_png16(p) for p in chunk])
                guide = None
                if guide_reader is not None:
                    g, g_valid = next(guide_reader, (None, 0))
                    if g is not None and g_valid >= valid:
                        guide = g[:valid]
                host, event = host_copy_async(
                    self._upscale(depth, guide, out_h, out_w, out_dtype))
                if pending is not None:
                    drain(pending)  # the previous batch, while this one runs
                pending = (host, event, n_done, valid)
                n_done += valid
                if n_done % 100 < valid:
                    dt = time.time() - t0
                    print(f"  {n_done} frames ({n_done / max(dt, 1e-9):.1f} "
                          f"fps)")
            if pending is not None:
                drain(pending)

        dt = time.time() - t0
        print(f"Upscale done: {n_done} frames in {dt:.1f}s "
              f"({n_done / max(dt, 1e-9):.1f} fps, writer "
              f"{self.writer_backend}) -> {output_path}")
        return output_path
