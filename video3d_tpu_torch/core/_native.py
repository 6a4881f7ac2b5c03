"""ctypes bindings for the native runtime library (native/png16.cc).

The native layer owns the host-side PNG16 encode path -- a persistent
C++ thread pool compresses a whole device batch in parallel with zero
GIL involvement (the reference leans on cv2.imwrite per frame,
depth.py:406). Falls back cleanly when the library hasn't been built:
``lib()`` returns None and callers use the cv2 path.

Build with ``make -C native`` (or native/build.sh).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libv3dpng.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build_if_source_newer() -> None:
    srcs = [
        p
        for p in (
            _LIB_PATH.parent / n
            for n in ("png16.cc", "mp4box.cc", "avio.cc")
        )
        if p.exists()
    ]
    if not srcs:
        return
    newest = max(p.stat().st_mtime for p in srcs)
    av_fresh = not (_LIB_PATH.parent / "avio.cc").exists() or (
        _AV_LIB_PATH.exists() and _AV_LIB_PATH.stat().st_mtime >= newest
    )
    if (
        _LIB_PATH.exists()
        and _LIB_PATH.stat().st_mtime >= newest
        and av_fresh
    ):
        return
    try:
        subprocess.run(
            ["make", "-C", str(_LIB_PATH.parent)],
            capture_output=True,
            timeout=120,
            check=True,
        )
    except Exception:
        pass  # no toolchain: stay on the cv2 fallback


def lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("VIDEO3D_TPU_NO_NATIVE"):
        return None
    _build_if_source_newer()
    if not _LIB_PATH.exists():
        return None
    try:
        l = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    l.v3d_png16_encode.restype = ctypes.c_size_t
    l.v3d_png16_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
    ]
    l.v3d_png_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    l.v3d_png16_decode.restype = ctypes.c_int
    l.v3d_png16_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    l.v3d_png16_encode_batch_to_files.restype = ctypes.c_int
    l.v3d_png16_encode_batch_to_files.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
    ]
    if hasattr(l, "v3d_mp4_cut"):
        l.v3d_mp4_cut.restype = ctypes.c_int
        l.v3d_mp4_cut.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double,
            ctypes.c_double, ctypes.c_char_p, ctypes.c_int,
        ]
    if hasattr(l, "v3d_mp4_concat"):
        l.v3d_mp4_concat.restype = ctypes.c_int
        l.v3d_mp4_concat.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ]
    if hasattr(l, "v3d_mp4_extract_pcm"):
        l.v3d_mp4_extract_pcm.restype = ctypes.c_int
        l.v3d_mp4_extract_pcm.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ]
    _lib = l
    return _lib


def cut_mp4(in_path: str, out_path: str, start_s: float,
            dur_s: float) -> Optional[str]:
    """Box-level MP4 stream copy of [start_s, start_s+dur_s).

    The video track snaps back to the previous keyframe (the ffmpeg
    ``-ss .. -c copy`` contract, reference extract_aligned.py:124-133);
    other tracks cut at that same time. Returns None on success, an
    error string on failure, and "native library unavailable" when the
    lib isn't built (callers fall back to a decode/re-encode path).
    """
    l = lib()
    if l is None or not hasattr(l, "v3d_mp4_cut"):
        return "native library unavailable"
    err = ctypes.create_string_buffer(512)
    rc = l.v3d_mp4_cut(
        str(in_path).encode(), str(out_path).encode(),
        float(start_s), float(dur_s), err, len(err),
    )
    if rc != 0:
        return err.value.decode(errors="replace") or "mp4 cut failed"
    return None


def concat_mp4(in_paths: List[str], out_path: str) -> Optional[str]:
    """Box-level stream-copy concat of same-codec MP4 segments.

    Joins the segment files the segment-parallel encoder writes
    (core/video.py SegmentParallelVideoWriter) without re-encoding:
    sample tables are merged and sample bytes copied verbatim. Every
    input must have byte-identical codec configuration (stsd) per
    track. Returns None on success, an error string on failure, and
    "native library unavailable" when the lib isn't built.
    """
    l = lib()
    if l is None or not hasattr(l, "v3d_mp4_concat"):
        return "native library unavailable"
    arr = (ctypes.c_char_p * len(in_paths))(
        *[str(p).encode() for p in in_paths]
    )
    err = ctypes.create_string_buffer(512)
    rc = l.v3d_mp4_concat(arr, len(in_paths), str(out_path).encode(), err,
                          len(err))
    if rc != 0:
        return err.value.decode(errors="replace") or "mp4 concat failed"
    return None


def encode_png16(depth: np.ndarray, zlevel: int = 1) -> Optional[bytes]:
    """Encode one uint16 (H, W) array to PNG bytes; None if no native lib."""
    l = lib()
    if l is None:
        return None
    depth = np.ascontiguousarray(depth, dtype=np.uint16)
    h, w = depth.shape
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = l.v3d_png16_encode(
        depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        h, w, zlevel, ctypes.byref(out),
    )
    if n == 0:
        return None
    try:
        return ctypes.string_at(out, n)
    finally:
        l.v3d_png_free(out)


def decode_png16(data: bytes, max_pixels: int = 64 << 20) -> Optional[np.ndarray]:
    """Decode grayscale PNG bytes to uint16 (H, W); None on failure."""
    l = lib()
    if l is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(max_pixels, np.uint16)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = l.v3d_png16_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.byref(h), ctypes.byref(w), max_pixels,
    )
    if rc != 0:
        return None
    return out[: h.value * w.value].reshape(h.value, w.value).copy()


def encode_batch_to_files(
    batch: np.ndarray, paths: List[str], zlevel: int = 1
) -> Optional[int]:
    """Encode+write a (N, H, W) uint16 batch in parallel (native pool).

    Returns the number of failures, or None if the native lib is absent.
    Blocks until all files are written.
    """
    l = lib()
    if l is None:
        return None
    batch = np.ascontiguousarray(batch, dtype=np.uint16)
    n, h, w = batch.shape
    assert len(paths) == n
    joined = b"\0".join(str(p).encode() for p in paths) + b"\0"
    return l.v3d_png16_encode_batch_to_files(
        batch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        n, h, w, zlevel, joined,
    )


def extract_pcm_wav(in_path: str, out_path: str) -> Optional[str]:
    """Extract an uncompressed PCM audio track from an MP4/MOV to WAV.

    Decodes nothing: QuickTime 'sowt'/'twos'/'raw '/'lpcm'-v0 and
    ISO-BMFF 'ipcm' sample bytes ARE the PCM, so alignment works without
    ffmpeg on such files. Returns None on success, an error string
    otherwise ("no uncompressed PCM audio track..." for AAC et al.).
    """
    l = lib()
    if l is None or not hasattr(l, "v3d_mp4_extract_pcm"):
        return "native library unavailable"
    err = ctypes.create_string_buffer(512)
    rc = l.v3d_mp4_extract_pcm(str(in_path).encode(),
                               str(out_path).encode(), err, len(err))
    if rc != 0:
        return err.value.decode(errors="replace") or "pcm extract failed"
    return None


# ---------------------------------------------------------------------------
# libav-backed media I/O (native/avio.cc -> libv3dav.so, optional)

_AV_LIB_PATH = _LIB_PATH.parent / "libv3dav.so"
_av_lib: Optional[ctypes.CDLL] = None
_av_tried = False


def av_lib() -> Optional[ctypes.CDLL]:
    """The libav-backed native library, or None if unavailable.

    Built only on hosts with the libav dev headers (native/Makefile);
    loading additionally requires the libav runtime (.so.59 etc.), so
    absence is normal and every caller has a non-native fallback.
    """
    global _av_lib, _av_tried
    if _av_tried:
        return _av_lib
    _av_tried = True
    if os.environ.get("VIDEO3D_TPU_NO_NATIVE") or os.environ.get(
        "VIDEO3D_TPU_NO_AV"
    ):
        return None
    lib()  # triggers the rebuild-if-stale pass for both libraries
    if not _AV_LIB_PATH.exists():
        return None
    try:
        l = ctypes.CDLL(str(_AV_LIB_PATH))
    except OSError:  # libav runtime missing at load time
        return None
    l.v3d_av_audio_to_wav.restype = ctypes.c_int
    l.v3d_av_audio_to_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
        ctypes.c_char_p, ctypes.c_int,
    ]
    l.v3d_av_reader_open.restype = ctypes.c_void_p
    l.v3d_av_reader_open.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int,
    ]
    l.v3d_av_reader_seek.restype = ctypes.c_int
    l.v3d_av_reader_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    l.v3d_av_reader_next.restype = ctypes.c_int
    l.v3d_av_reader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)
    ]
    l.v3d_av_reader_close.argtypes = [ctypes.c_void_p]
    l.v3d_av_writer_open.restype = ctypes.c_void_p
    l.v3d_av_writer_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    l.v3d_av_writer_write.restype = ctypes.c_int
    l.v3d_av_writer_write.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)
    ]
    l.v3d_av_writer_close.restype = ctypes.c_int
    l.v3d_av_writer_close.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
    ]
    if hasattr(l, "v3d_av_mux"):
        l.v3d_av_mux.restype = ctypes.c_int
        l.v3d_av_mux.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int,
        ]
    if hasattr(l, "v3d_av_wav_to_m4a"):
        l.v3d_av_wav_to_m4a.restype = ctypes.c_int
        l.v3d_av_wav_to_m4a.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
        ]
    _av_lib = l
    return _av_lib


def av_audio_to_wav(
    in_path: str, out_path: str, rate: int, max_duration: float = 0.0
) -> Optional[str]:
    """Decode any audio track to mono 16-bit WAV at ``rate`` (libav).

    Handles every codec the host's libavcodec decodes (AAC-LC, AC3,
    MP3, Opus, PCM variants ...), replacing the ffmpeg subprocess of
    the reference (utils.py:76-105). ``max_duration`` of 0 decodes the
    whole track. Returns None on success, an error string otherwise.
    """
    l = av_lib()
    if l is None:
        return "libav native library unavailable"
    err = ctypes.create_string_buffer(512)
    rc = l.v3d_av_audio_to_wav(
        str(in_path).encode(), str(out_path).encode(), int(rate),
        float(max_duration), err, len(err),
    )
    if rc != 0:
        return err.value.decode(errors="replace") or "audio decode failed"
    return None


class AVReader:
    """Streaming libav frame reader: RGB24 frames with frame seek.

    In-process replacement for both reference decode paths (OpenCV
    VideoCapture, depth.py:163-182, and the ffmpeg rawvideo pipe,
    depth.py:215-220): no subprocess, no BGR detour, frame-accurate
    ``seek`` (keyframe seek + decode-drop, the demuxer contract cv2's
    CAP_PROP_POS_FRAMES approximates).
    """

    def __init__(self, path: str):
        l = av_lib()
        if l is None:
            raise RuntimeError("libav native library unavailable")
        self._l = l
        err = ctypes.create_string_buffer(512)
        w = ctypes.c_int()
        h = ctypes.c_int()
        fps = ctypes.c_double()
        n = ctypes.c_int64()
        self._h = l.v3d_av_reader_open(
            str(path).encode(), ctypes.byref(w), ctypes.byref(h),
            ctypes.byref(fps), ctypes.byref(n), err, len(err),
        )
        if not self._h:
            raise RuntimeError(
                f"libav open failed: {err.value.decode(errors='replace')}"
            )
        self.width, self.height = w.value, h.value
        self.fps = fps.value
        self.n_frames = n.value if n.value > 0 else None

    def seek(self, frame_idx: int) -> bool:
        return self._l.v3d_av_reader_seek(self._h, int(frame_idx)) == 0

    def read(self) -> Optional[np.ndarray]:
        """Next RGB frame (H, W, 3) uint8, or None at end of stream."""
        out = np.empty((self.height, self.width, 3), np.uint8)
        rc = self._l.v3d_av_reader_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        )
        if rc == 1:
            return out
        if rc == 0:
            return None
        raise RuntimeError("libav decode failed")

    def close(self) -> None:
        if self._h:
            self._l.v3d_av_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


class AVWriter:
    """Streaming libav/libx264 encoder (yuv420p, crf/preset contract).

    In-process replacement for the reference's ffmpeg encode subprocess
    (upscale.py:47-63). ``gray=True`` enables the grayscale fast path:
    depth maps are single-channel, so Y is a 256-entry limited-range
    LUT and U=V=128 -- no RGB expansion, no per-pixel color matrix.
    """

    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        fps: float,
        crf: int = 18,
        preset: str = "medium",
        gray: bool = False,
        threads: int = 0,
    ):
        l = av_lib()
        if l is None:
            raise RuntimeError("libav native library unavailable")
        self._l = l
        err = ctypes.create_string_buffer(512)
        self.gray = bool(gray)
        self.width, self.height = int(width), int(height)
        self._h = l.v3d_av_writer_open(
            str(path).encode(), self.width, self.height, float(fps),
            int(crf), preset.encode(), 1 if gray else 0, int(threads),
            err, len(err),
        )
        if not self._h:
            raise RuntimeError(
                f"libav encoder open failed: "
                f"{err.value.decode(errors='replace')}"
            )

    def write(self, frame: np.ndarray) -> None:
        expect = (
            (self.height, self.width)
            if self.gray
            else (self.height, self.width, 3)
        )
        if frame.shape != expect or frame.dtype != np.uint8:
            raise ValueError(
                f"AVWriter expects uint8 {expect}, got "
                f"{frame.dtype} {frame.shape}"
            )
        frame = np.ascontiguousarray(frame)
        rc = self._l.v3d_av_writer_write(
            self._h, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        )
        if rc != 0:
            h, self._h = self._h, None
            self._l.v3d_av_writer_close(h, None, 0)  # free the session
            raise RuntimeError("libav encode failed")

    def close(self) -> None:
        if self._h:
            err = ctypes.create_string_buffer(512)
            rc = self._l.v3d_av_writer_close(self._h, err, len(err))
            self._h = None
            if rc != 0:
                raise RuntimeError(
                    f"libav encoder close failed: "
                    f"{err.value.decode(errors='replace')}"
                )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def av_wav_to_m4a(
    in_wav: str, out_path: str, bitrate: int = 128000
) -> Optional[str]:
    """Encode a PCM WAV to AAC-LC in an M4A/MP4 container (libav).

    Round-trip partner of :func:`av_audio_to_wav` for tests and
    sidecar-audio tooling on ffmpeg-less hosts. Returns None on
    success, an error string otherwise.
    """
    l = av_lib()
    if l is None:
        return "libav native library unavailable"
    err = ctypes.create_string_buffer(512)
    rc = l.v3d_av_wav_to_m4a(
        str(in_wav).encode(), str(out_path).encode(), int(bitrate),
        err, len(err),
    )
    if rc != 0:
        return err.value.decode(errors="replace") or "aac encode failed"
    return None


def av_mux(video_path: str, audio_path: str, out_path: str) -> Optional[str]:
    """Stream-copy mux: video track of one file + audio track of another
    into a single MP4 (no transcode). Returns None on success."""
    l = av_lib()
    if l is None or not hasattr(l, "v3d_av_mux"):
        return "libav native library unavailable"
    err = ctypes.create_string_buffer(512)
    rc = l.v3d_av_mux(
        str(video_path).encode(), str(audio_path).encode(),
        str(out_path).encode(), err, len(err),
    )
    if rc != 0:
        return err.value.decode(errors="replace") or "mux failed"
    return None
