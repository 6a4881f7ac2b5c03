"""16-bit PNG depth-map sequence I/O.

The depth stage's artifact is a ``depth_%06d.png`` uint16 sequence in a
content-hashed cache dir (reference depth.py:397-406, depth.py:466).
Writing is the host-side bottleneck at high frame rates, so the
``DepthMapWriter`` runs a small thread pool -- cv2.imencode releases the
GIL, so PNG compression genuinely parallelizes across cores while the TPU
computes the next batch.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List

import cv2
import numpy as np

from video3d_tpu_torch.core.cache import depth_frame_name


def save_depth_png16(path: str | Path, depth: np.ndarray) -> None:
    """Save one uint16 depth map as PNG (reference depth.py:406).

    Prefers the native C++ encoder (core/_native.py); cv2 fallback.
    """
    if depth.dtype != np.uint16:
        raise TypeError(f"depth PNG expects uint16, got {depth.dtype}")
    from video3d_tpu_torch.core import _native

    data = _native.encode_png16(depth)
    if data is not None:
        Path(path).write_bytes(data)
        return
    if not cv2.imwrite(str(path), depth):
        raise RuntimeError(f"Failed to write depth PNG: {path}")


def load_depth_png16(path: str | Path) -> np.ndarray:
    from video3d_tpu_torch.core import _native

    if _native.lib() is not None:
        out = _native.decode_png16(Path(path).read_bytes())
        if out is not None:
            return out
    depth = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if depth is None:
        raise RuntimeError(f"Failed to read depth PNG: {path}")
    return depth


def list_depth_frames(cache_dir: str | Path) -> List[Path]:
    """Sorted depth_*.png frames in a cache dir (reference upscale.py:31-36)."""
    return sorted(Path(cache_dir).glob("depth_*.png"))


class DepthMapWriter:
    """Asynchronous writer for a depth PNG16 sequence.

    ``put(batch_uint16, start_index, valid)`` schedules PNG encodes on a
    thread pool and returns immediately; ``close()`` drains and re-raises
    the first failure. Filenames follow the reference contract
    ``depth_%06d.png`` numbered from 0 within the cache dir.
    """

    def __init__(self, cache_dir: str | Path, workers: int = 8):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._futures: list = []

    def put(self, batch: np.ndarray, start_index: int, valid: int) -> None:
        batch = np.asarray(batch)
        from video3d_tpu_torch.core import _native

        if _native.lib() is not None:
            # native path: one call hands the whole batch to the C++
            # thread pool (no GIL, parallel deflate); scheduled on the
            # Python pool only so put() stays non-blocking
            paths = [
                str(self.cache_dir / depth_frame_name(start_index + i))
                for i in range(valid)
            ]
            chunk = np.ascontiguousarray(batch[:valid]).copy()

            def write_native():
                failures = _native.encode_batch_to_files(chunk, paths)
                if failures:
                    raise RuntimeError(
                        f"native PNG encode failed for {failures} frames"
                    )

            self._futures.append(self._pool.submit(write_native))
            return
        for i in range(valid):
            path = self.cache_dir / depth_frame_name(start_index + i)
            # copy: the caller may reuse/overwrite the batch buffer
            self._futures.append(
                self._pool.submit(save_depth_png16, path, batch[i].copy())
            )

    def close(self) -> None:
        for f in self._futures:
            f.result()
        self._futures.clear()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
