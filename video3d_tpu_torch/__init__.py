"""PyTorch + CUDA port of video3d_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module names (``ops``, ``kernels``, ``stages``,
``cli``); imports ``torch`` and never ``jax``. Host I/O (video decode,
PNG16 writing, cache keys) is shared with the JAX package through
``video3d_tpu.core``, which is JAX-free. The first slice is the
stereo-only depth stage: ``python -m video3d_tpu_torch.cli.depth
<sbs.mp4> --stereo-only``.
"""
