"""Streaming video decode/encode feeding the TPU pipeline.

The reference buffers every decoded frame of the clip in RAM
(depth.py:142-188) -- a feature film cannot fit. Here decode is a streaming
producer on a background thread filling a bounded queue of fixed-size numpy
batches, so host decode overlaps device compute (double buffering at the
host->HBM boundary, SURVEY.md north star).

Backends (auto-selection order):
* ``av`` -- in-process libavformat/libavcodec via the native library
  (native/avio.cc): no subprocess, no pipe copy, frame-accurate seek,
  and the SAME libx264 crf/preset encode contract as the ffmpeg CLI --
  plus a grayscale encode fast path (Y=LUT, U=V=128) that skips the
  3-channel expansion entirely for depth maps. Preferred when built.
* ``ffmpeg`` -- rawvideo rgb24 pipe subprocess (reference depth.py:215-220),
  used when an ffmpeg binary exists;
* ``opencv`` -- cv2.VideoCapture (reference depth.py:142-188), always
  available; frames converted BGR->RGB at the boundary so the rest of the
  framework is RGB-only (fixing the reference's color-space confusion,
  SURVEY.md SS2.4-7). Encode falls back to cv2.VideoWriter mp4v.
"""

from __future__ import annotations

import queue
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def av_available() -> bool:
    """True when the libav-backed native library loads on this host."""
    from video3d_tpu_torch.core import _native

    return _native.av_lib() is not None


def _default_backend() -> str:
    if av_available():
        return "av"
    if ffmpeg_available():
        return "ffmpeg"
    return "opencv"


class VideoReader:
    """Streaming batched RGB frame reader.

    Iterating yields ``(batch, valid)`` where ``batch`` is uint8
    ``(batch_size, H, W, 3)`` RGB and ``valid <= batch_size`` is the number
    of real frames (the tail batch is zero-padded so shapes stay static for
    XLA). Frames are produced by a background decode thread through a
    bounded queue (depth ``prefetch`` batches).
    """

    def __init__(
        self,
        video_path: str,
        start_frame: int = 0,
        max_frames: Optional[int] = None,
        batch_size: int = 8,
        prefetch: int = 2,
        backend: Optional[str] = None,
    ):
        self.video_path = str(video_path)
        if not Path(video_path).exists():
            raise FileNotFoundError(f"Video not found: {video_path}")
        self.start_frame = int(start_frame)
        self.max_frames = max_frames
        self.batch_size = int(batch_size)
        self.prefetch = int(prefetch)
        if backend is None:
            backend = _default_backend()
        self.backend = backend

        from video3d_tpu_torch.core.probe import get_video_info

        info = get_video_info(self.video_path)
        if info is None:
            raise RuntimeError(f"Cannot probe video: {video_path}")
        self.info = info
        total = info["frames"] - self.start_frame if info["frames"] else None
        if max_frames is not None:
            total = max_frames if total is None else min(total, max_frames)
        self.n_frames = total  # None if container hides nb_frames

    # -- frame producers ---------------------------------------------------

    def _frames_opencv(self) -> Iterator[np.ndarray]:
        import cv2

        cap = cv2.VideoCapture(self.video_path)
        if not cap.isOpened():
            raise RuntimeError(f"OpenCV cannot open: {self.video_path}")
        try:
            if self.start_frame:
                cap.set(cv2.CAP_PROP_POS_FRAMES, self.start_frame)
            count = 0
            while self.max_frames is None or count < self.max_frames:
                ok, frame = cap.read()
                if not ok:
                    break
                yield frame[..., ::-1]  # BGR -> RGB
                count += 1
        finally:
            cap.release()

    def _frames_ffmpeg(self) -> Iterator[np.ndarray]:
        w, h, fps = self.info["width"], self.info["height"], self.info["fps"]
        cmd = [shutil.which("ffmpeg"), "-v", "error"]
        if self.start_frame and fps > 0:
            cmd += ["-ss", f"{self.start_frame / fps:.6f}"]
        cmd += ["-i", self.video_path]
        if self.max_frames is not None:
            cmd += ["-frames:v", str(self.max_frames)]
        cmd += ["-f", "rawvideo", "-pix_fmt", "rgb24", "pipe:1"]
        frame_bytes = w * h * 3
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, bufsize=frame_bytes * 4)
        try:
            while True:
                buf = proc.stdout.read(frame_bytes)
                if len(buf) < frame_bytes:
                    break
                yield np.frombuffer(buf, np.uint8).reshape(h, w, 3)
        finally:
            proc.stdout.close()
            proc.wait()

    def _frames_av(self) -> Iterator[np.ndarray]:
        from video3d_tpu_torch.core._native import AVReader

        with AVReader(self.video_path) as r:
            if self.start_frame and not r.seek(self.start_frame):
                raise RuntimeError(
                    f"libav seek to frame {self.start_frame} failed: "
                    f"{self.video_path}"
                )
            count = 0
            while self.max_frames is None or count < self.max_frames:
                frame = r.read()
                if frame is None:
                    break
                yield frame
                count += 1

    def frames(self) -> Iterator[np.ndarray]:
        """Yield single RGB uint8 (H, W, 3) frames."""
        if self.backend == "av":
            return self._frames_av()
        if self.backend == "ffmpeg":
            return self._frames_ffmpeg()
        return self._frames_opencv()

    # -- batched, prefetched iteration --------------------------------------

    def __iter__(self):
        h, w = self.info["height"], self.info["width"]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            batch = np.zeros((self.batch_size, h, w, 3), np.uint8)
            n = 0
            try:
                for frame in self.frames():
                    if stop.is_set():
                        return
                    batch[n] = frame
                    n += 1
                    if n == self.batch_size:
                        q.put((batch, n))
                        batch = np.zeros((self.batch_size, h, w, 3), np.uint8)
                        n = 0
                if n:
                    q.put((batch, n))
            except Exception as e:  # surface decode errors to the consumer
                q.put(e)
                return
            q.put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


class VideoWriter:
    """Streaming video encoder for grayscale/RGB uint8 frames.

    The ``av`` and ``ffmpeg`` backends reproduce the reference's encode
    contract (upscale.py:47-63): h264, crf=18, preset=medium, yuv420p --
    ``av`` in-process through libavcodec/libx264 (no subprocess, and a
    grayscale fast path for depth maps), ``ffmpeg`` through the CLI pipe.
    ``use_nvenc`` is accepted for CLI parity but NVENC does not exist on
    TPU hosts, so it selects libx264. OpenCV fallback uses mp4v.
    """

    def __init__(
        self,
        output_path: str,
        width: int,
        height: int,
        fps: float,
        crf: int = 18,
        preset: str = "medium",
        use_nvenc: bool = False,
        backend: Optional[str] = None,
        threads: int = 0,
    ):
        """``threads`` sets the encoder's internal (x264 frame-level)
        thread count; 0 = auto (x264 picks ~1.5x cores). Orthogonal to
        :class:`SegmentParallelVideoWriter`'s ``workers`` -- x264 frame
        threads scale one encoder instance across cores with no segment
        bookkeeping, at a small quality/ratecontrol cost; segment
        workers scale perfectly but need the box-level concat."""
        self.output_path = str(output_path)
        self.width, self.height, self.fps = int(width), int(height), float(fps)
        if backend is None:
            backend = _default_backend()
        self.backend = backend
        self._proc = None
        self._cv = None
        self._av = None
        self._crf, self._preset = int(crf), preset
        self._enc_threads = int(threads)
        if self.backend == "av":
            pass  # opened lazily: gray vs RGB mode comes from frame 1
        elif self.backend == "ffmpeg":
            cmd = [
                shutil.which("ffmpeg"), "-y", "-v", "error",
                "-f", "rawvideo", "-pix_fmt", "rgb24",
                "-s", f"{self.width}x{self.height}", "-r", f"{self.fps:.6f}",
                "-i", "pipe:0",
                "-c:v", "libx264", "-crf", str(crf), "-preset", preset,
                *(["-threads", str(self._enc_threads)]
                  if self._enc_threads > 0 else []),
                "-pix_fmt", "yuv420p", self.output_path,
            ]
            self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
        else:
            import cv2

            self._cv = cv2.VideoWriter(
                self.output_path,
                cv2.VideoWriter_fourcc(*"mp4v"),
                self.fps,
                (self.width, self.height),
            )
            if not self._cv.isOpened():
                raise RuntimeError(f"Cannot open video writer: {output_path}")

    def write(self, frame: np.ndarray) -> None:
        """Write one uint8 frame: (H, W) grayscale or (H, W, 3) RGB."""
        if frame.dtype != np.uint8:
            raise TypeError(f"VideoWriter expects uint8, got {frame.dtype}")
        if self.backend == "av":
            if self._av is None:
                from video3d_tpu_torch.core._native import AVWriter

                self._av = AVWriter(
                    self.output_path, self.width, self.height, self.fps,
                    crf=self._crf, preset=self._preset,
                    gray=(frame.ndim == 2), threads=self._enc_threads,
                )
            if frame.ndim == 2 and not self._av.gray:
                frame = np.repeat(frame[..., None], 3, axis=-1)
            elif frame.ndim == 3 and self._av.gray:
                raise ValueError(
                    "VideoWriter opened in grayscale mode (first frame was "
                    "2-D); cannot switch to RGB mid-stream"
                )
            self._av.write(frame)
            return
        if self._proc is not None:
            if frame.ndim == 2:
                frame = np.repeat(frame[..., None], 3, axis=-1)
            self._proc.stdin.write(np.ascontiguousarray(frame).tobytes())
        else:
            # cv2 SIMD color conversions beat numpy's repeat / negative-
            # stride flip by ~4x at 4K -- on single-core TPU hosts the
            # feed path shares the encoder's core, so this is throughput
            import cv2

            if frame.ndim == 2:
                self._cv.write(cv2.cvtColor(frame, cv2.COLOR_GRAY2BGR))
            else:
                self._cv.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))

    def close(self) -> None:
        if self.backend == "av":
            if self._av is None:  # zero frames written: emit empty mp4
                from video3d_tpu_torch.core._native import AVWriter

                self._av = AVWriter(
                    self.output_path, self.width, self.height, self.fps,
                    crf=self._crf, preset=self._preset,
                    threads=self._enc_threads,
                )
            av, self._av = self._av, None
            av.close()
            return
        if self._proc is not None:
            self._proc.stdin.close()
            ret = self._proc.wait()
            self._proc = None
            if ret != 0:
                raise RuntimeError(f"ffmpeg encoder exited with {ret}")
        if self._cv is not None:
            self._cv.release()
            self._cv = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SegmentParallelVideoWriter:
    """Segment-parallel encoder: N workers, box-level concat at close.

    The reference offloads encoding to NVENC (reference upscale.py:56);
    TPU hosts have no hardware encoder, and a single libx264 instance
    tops out far below the device's 4K throughput. This writer splits
    the (sequential) frame stream into contiguous ``segment_frames``
    runs, encodes each on one of ``workers`` threads -- every worker
    owns its own encoder, and both cv2 and the ffmpeg pipe release the
    GIL during encode, so real hosts scale with cores -- then stitches
    the segments with the native box-level stream copy
    (native/mp4box.cc v3d_mp4_concat): no re-encode, frames
    bit-identical to each segment's own output.

    Interface matches :class:`VideoWriter` (write/close/context
    manager). Segment boundaries start fresh encoder instances, so each
    segment begins with a keyframe; identical settings keep the
    decoder configuration byte-compatible for the concat.
    """

    def __init__(
        self,
        output_path: str,
        width: int,
        height: int,
        fps: float,
        workers: int = 4,
        segment_frames: int = 240,
        crf: int = 18,
        preset: str = "medium",
        backend: Optional[str] = None,
        threads: int = 1,
    ):
        """``threads`` is each worker's x264-internal thread count
        (default 1: with N segment workers already pinning N cores,
        letting every instance auto-spawn ~1.5x-cores x264 threads
        oversubscribes the host; raise it only when workers < cores)."""
        import queue as _queue
        import threading

        self.output_path = str(output_path)
        self.width, self.height, self.fps = int(width), int(height), float(fps)
        self.segment_frames = int(segment_frames)
        self.workers = max(1, int(workers))
        self._crf, self._preset, self._backend = crf, preset, backend
        self._enc_threads = int(threads)
        self._n = 0
        self._segments: list = []
        self._tmpdir = Path(self.output_path).parent
        self._queues = [
            _queue.Queue(maxsize=8) for _ in range(self.workers)
        ]
        self._errors: list = []
        self._threads = [
            threading.Thread(target=self._worker, args=(i,), daemon=True)
            for i in range(self.workers)
        ]
        for t in self._threads:
            t.start()

    def _segment_path(self, seg: int) -> str:
        stem = Path(self.output_path).stem
        return str(self._tmpdir / f".{stem}.seg{seg:05d}.mp4")

    def _worker(self, wid: int) -> None:
        q = self._queues[wid]
        writer = None
        cur_seg = -1
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                seg, frame = item
                if seg != cur_seg:
                    if writer is not None:
                        writer.close()
                    writer = VideoWriter(
                        self._segment_path(seg), self.width, self.height,
                        self.fps, crf=self._crf, preset=self._preset,
                        backend=self._backend, threads=self._enc_threads,
                    )
                    cur_seg = seg
                writer.write(frame)
        except Exception as e:  # surface at close()
            self._errors.append(e)
        finally:
            if writer is not None:
                try:
                    writer.close()
                except Exception as e:
                    self._errors.append(e)

    def write(self, frame: np.ndarray) -> None:
        seg = self._n // self.segment_frames
        if seg >= len(self._segments):
            self._segments.append(self._segment_path(seg))
        self._queues[seg % self.workers].put((seg, frame))
        self._n += 1

    def close(self) -> None:
        if not self._threads:
            return
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join()
        self._threads = []
        if self._errors:
            raise RuntimeError(f"segment encoder failed: {self._errors[0]}")
        if not self._segments:
            # zero frames: emit an empty container via a plain writer
            VideoWriter(self.output_path, self.width, self.height,
                        self.fps, backend=self._backend).close()
            return
        try:
            if len(self._segments) == 1:
                Path(self._segments[0]).replace(self.output_path)
                return
            from video3d_tpu_torch.core._native import concat_mp4

            err = concat_mp4(self._segments, self.output_path)
            if err is not None:
                # fallback: decode each segment and re-encode serially
                # (lossy, slow -- only when the native lib is absent or
                # the container defeats the box parser)
                print(f"native concat unavailable ({err}); re-encoding")
                with VideoWriter(self.output_path, self.width, self.height,
                                 self.fps, crf=self._crf,
                                 preset=self._preset,
                                 backend=self._backend) as w:
                    for seg in self._segments:
                        for batch, valid in VideoReader(seg, batch_size=8):
                            for j in range(valid):
                                w.write(batch[j])
        finally:
            for seg in self._segments:
                try:
                    Path(seg).unlink(missing_ok=True)
                except OSError:
                    pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
