"""PyTorch + CUDA port of video3d_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module names (``ops``, ``kernels``, ``models``,
``stages``, ``cli``, ``core``); imports ``torch`` and never ``jax``, and
nothing of ``video3d_tpu``. Host I/O (video decode, PNG16 writing, cache
keys, H.264 encode) is the port's own copy, ``video3d_tpu_torch.core``.
Ported so far: the depth stage (``python -m video3d_tpu_torch.cli.depth
<sbs.mp4>``) with its default CREStereo hybrid on the bundled weights
(``weights/``), stereo-only (``--stereo-only``) with every matcher mode
(2, 4, 5 and 8 paths) and both horizontal routes, the temporal smoothers
and the DPT hybrid (``--guidance dpt``); and the 4K upscale
(``python -m video3d_tpu_torch.cli.upscale <depth_dir> <video_4k>``).
"""
