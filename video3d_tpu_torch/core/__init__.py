"""Host-side media I/O and artifact store of the port.

A copy of what the port uses from the JAX package's host layer: probing,
streaming frame decode and encode, 16-bit PNG depth-map I/O, content-hash
cache keys and the work-dir layout. It imports neither ``jax`` nor ``torch``, and
nothing of ``video3d_tpu``. ``_native`` loads the C++ PNG16 encoder and
the MP4 reader from ``native/`` at the root of the checkout (built there
with ``make -C native`` at first use; OpenCV otherwise). Device code
never touches this layer except through numpy arrays.
"""

from video3d_tpu_torch.core.cache import (
    content_key,
    create_work_directory,
    depth_cache_dir,
    is_depth_cached,
    is_depth_cached_range,
)
from video3d_tpu_torch.core.depthio import (
    DepthMapWriter,
    list_depth_frames,
    load_depth_png16,
    save_depth_png16,
)
from video3d_tpu_torch.core.probe import get_video_info
from video3d_tpu_torch.core.video import (SegmentParallelVideoWriter,
                                          VideoReader, VideoWriter)

__all__ = [
    "get_video_info",
    "content_key",
    "create_work_directory",
    "depth_cache_dir",
    "is_depth_cached",
    "is_depth_cached_range",
    "VideoReader",
    "VideoWriter",
    "SegmentParallelVideoWriter",
    "save_depth_png16",
    "load_depth_png16",
    "list_depth_frames",
    "DepthMapWriter",
]
