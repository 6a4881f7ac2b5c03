"""Video container probing and compatibility checks.

Mirrors the behavior of the reference's ``get_video_info`` /
``verify_video_compatibility`` (reference: src/video_3d_pipeline/utils.py:17-38,
utils.py:228-259) with two deliberate fixes (SURVEY.md SS2.4-10):

* frame rates are parsed with ``fractions.Fraction``, never ``eval()``;
* probing works without ffprobe by falling back to OpenCV.
"""

from __future__ import annotations

import json
import shutil
import subprocess
from fractions import Fraction
from pathlib import Path
from typing import Dict, Optional


def _probe_ffprobe(video_path: str) -> Optional[Dict]:
    ffprobe = shutil.which("ffprobe")
    if ffprobe is None:
        return None
    try:
        out = subprocess.run(
            [
                ffprobe,
                "-v", "error",
                "-select_streams", "v:0",
                "-show_entries",
                "stream=width,height,r_frame_rate,duration,nb_frames",
                "-of", "json",
                str(video_path),
            ],
            capture_output=True,
            check=True,
            text=True,
        ).stdout
    except (subprocess.CalledProcessError, OSError):
        return None
    streams = json.loads(out).get("streams") or []
    if not streams:
        return None
    s = streams[0]
    fps = float(Fraction(s.get("r_frame_rate", "0/1")))
    frames = int(s.get("nb_frames", 0) or 0)
    duration = float(s.get("duration", 0.0) or 0.0)
    if duration == 0.0 and frames and fps:
        duration = frames / fps
    return {
        "width": int(s["width"]),
        "height": int(s["height"]),
        "fps": fps,
        "duration": duration,
        "frames": frames,
    }


def _probe_opencv(video_path: str) -> Optional[Dict]:
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        return None
    try:
        width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        fps = float(cap.get(cv2.CAP_PROP_FPS))
        frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()
    duration = frames / fps if fps > 0 else 0.0
    return {
        "width": width,
        "height": height,
        "fps": fps,
        "duration": duration,
        "frames": frames,
    }


def get_video_info(video_path: str) -> Optional[Dict]:
    """Probe a video file; returns dict(width, height, fps, duration, frames).

    Same result schema as the reference (utils.py:28-36). Returns None when
    the file cannot be probed (reference returns None on error, utils.py:38).
    """
    path = Path(video_path)
    if not path.exists():
        print(f"Error getting video info: file not found: {video_path}")
        return None
    if path.suffix.lower() == ".wav":
        # audio-only input (ffmpeg-less alignment path): no video stream
        import wave

        with wave.open(str(path), "rb") as w:
            duration = w.getnframes() / float(w.getframerate())
        return {"width": 0, "height": 0, "fps": 0.0, "duration": duration,
                "frames": 0}
    info = _probe_ffprobe(video_path)
    if info is None:
        info = _probe_opencv(video_path)
    if info is None:
        print(f"Error getting video info: unreadable: {video_path}")
    return info


def verify_video_compatibility(
    video1_path: str,
    video2_path: str,
    duration_tolerance: float = 0.02,
    fps_tolerance: float = 0.1,
) -> bool:
    """Gate that two videos plausibly show the same content.

    Numeric contract from the reference (utils.py:242 duration within 2%,
    utils.py:249 fps within 0.1). Prints findings like the reference.
    """
    info1 = get_video_info(video1_path)
    info2 = get_video_info(video2_path)
    if info1 is None or info2 is None:
        print("Compatibility check failed: could not probe one of the videos")
        return False

    ok = True
    d1, d2 = info1["duration"], info2["duration"]
    if max(d1, d2) > 0:
        rel = abs(d1 - d2) / max(d1, d2)
        if rel > duration_tolerance:
            print(
                f"Warning: Duration mismatch: {d1:.1f}s vs {d2:.1f}s "
                f"({rel * 100:.1f}% > {duration_tolerance * 100:.0f}%)"
            )
            ok = False
    if abs(info1["fps"] - info2["fps"]) > fps_tolerance:
        print(f"Warning: FPS mismatch: {info1['fps']:.3f} vs {info2['fps']:.3f}")
        ok = False
    if ok:
        print("Videos appear compatible for alignment")
    return ok
