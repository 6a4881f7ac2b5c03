"""Content-hash cache keys and work-dir layout (the artifact store).

The inter-stage contract is file based (SURVEY.md SS1): stages communicate
only through a work directory containing ``alignment_data.json``, a depth
PNG16 sequence directory, cached audio WAVs and the final depth video.
Cache-key formats reproduce the reference exactly so runs are idempotent
and resumable (reference: depth.py:116-125, utils.py:61-62).
"""

from __future__ import annotations

import hashlib
from pathlib import Path


def content_key(*parts) -> str:
    """First 16 hex chars of md5 over '_'-joined parts (reference depth.py:119-120)."""
    joined = "_".join(str(p) for p in parts)
    return hashlib.md5(joined.encode()).hexdigest()[:16]


def create_work_directory(work_dir: str) -> Path:
    """Create (if needed) and return the work dir (reference utils.py:292-296)."""
    path = Path(work_dir)
    path.mkdir(parents=True, exist_ok=True)
    return path


def depth_cache_dir(
    work_dir: str | Path,
    video_path: str,
    start_frame: int,
    frame_count,
    model_checkpoint: str,
    unsqueeze: bool,
) -> Path:
    """Depth PNG cache directory ``depth_<md5-16>`` (reference depth.py:116-125)."""
    key = content_key(video_path, start_frame, frame_count, model_checkpoint, unsqueeze)
    return Path(work_dir) / f"depth_{key}"


def audio_cache_path(
    work_dir: str | Path, video_path: str, duration: float, sample_rate: int
) -> Path:
    """Audio WAV cache path ``audio_cache_<md5-16>.wav`` (reference utils.py:61-62)."""
    key = content_key(video_path, duration, sample_rate)
    return Path(work_dir) / f"audio_cache_{key}.wav"


def depth_frame_name(index: int) -> str:
    """Frame filename in a depth cache dir (reference depth.py:466: depth_%06d.png)."""
    return f"depth_{index:06d}.png"


def is_depth_cached(cache_dir: str | Path, frame_count: int) -> bool:
    """Cache hit requires ALL expected frames present (reference depth.py:127-140)."""
    return is_depth_cached_range(cache_dir, 0, frame_count)


def is_depth_cached_range(
    cache_dir: str | Path, start: int, count: int
) -> bool:
    """Completeness check for a sub-range [start, start+count) of a shared
    multi-host cache dir (frame indices are global)."""
    cache = Path(cache_dir)
    if not cache.exists():
        return False
    return all(
        (cache / depth_frame_name(i)).exists()
        for i in range(start, start + count)
    )
