"""PyTorch + CUDA port of video3d_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module names (``ops``, ``kernels``, ``models``,
``stages``, ``cli``); imports ``torch`` and never ``jax``. Host I/O (video decode,
PNG16 writing, cache keys) is shared with the JAX package through
``video3d_tpu.core``, which is JAX-free. Ported so far: the stereo-only
depth stage (``python -m video3d_tpu_torch.cli.depth <sbs.mp4>
--stereo-only``), the temporal smoothers, and the DPT hybrid
(``--guidance dpt``, ``models/``).
"""
